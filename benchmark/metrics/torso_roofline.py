"""torso_roofline: the least time of the convs the torso kernels computed in
the traced window (``arch.epoch_torso_bound_s`` times its epochs: each
kernel's larger of operations at the product rate and bytes at the memory
rate) over those kernels' device time in the trace, in %.  The kernels are
found by the names below.  Layer: the kernels (``ops/fused_resblock.py``,
``ops/csrc/fused_resblock_{tf32,mma}.cu``)."""

NAMES = ("res_stage_tf32_kernel", "feat_pool_tf32_kernel", "conv_tiled_tf32_kernel",
         "split_weights_kernel", "res_stage_mma_kernel", "feat_pool_mma_kernel",
         "conv_tiled_mma_kernel", "round_weights_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.on_card:
        return None
    seconds = sum(s for name, s in t.device_s.items() if any(n in name for n in NAMES))
    if seconds <= 0:
        return None
    bound = ctx.cell.arch.epoch_torso_bound_s(ctx.config, ctx.workload) * t.epochs
    return 100.0 * bound / seconds
