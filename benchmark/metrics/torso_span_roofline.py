"""torso_span_roofline: the least time of the torso work the program counted
in the window over the device time of its ``torso`` span, in %.

The work is every conv block of ``arch.convs`` (routed to a fused kernel or
not) over the frames and members the span counted (``_stage/torso.frames``,
``_stage/torso.members``, summed over the window's reports): for each block
the larger of its operations at the configuration's peak and its bytes at
the memory rate, each frame's float32 activations in and out once and each
member's float32 weights, bias and BN fold once.  The time is
``_stage/torso.device``, the span's CUDA events, from the raw frames to the
fc layer, whatever kernels ran inside.  Layer: the kernels."""

from benchmark import peaks


def _block_bound_s(conv, conv_flops, frames: float, members: float, dtype: str) -> float:
    if conv.kind == "feat":
        out_hw = ((conv.H + 1) // 2) * ((conv.W + 1) // 2)
        act = conv.ci * conv.H * conv.W + conv.co * out_hw
        weights = conv.co * 9 * conv.ci + conv.co + 2 * conv.ci
    else:
        act = 2 * conv.ci * conv.H * conv.W
        weights = 4 * (conv.co * 9 * conv.ci + 3 * conv.co)
    return peaks.bound_s(frames * conv_flops(conv), 4.0 * (frames * act + members * weights),
                         dtype)


def read(ctx):
    reports = ctx.window.reports
    seconds = sum(r.get("_stage/torso.device", 0.0) for r in reports)
    if seconds <= 0:
        return None
    frames = sum(r.get("_stage/torso.frames", 0) for r in reports)
    members = sum(r.get("_stage/torso.members", 0) for r in reports)
    arch, dtype = ctx.cell.arch, ctx.config["compute_dtype"]
    bound = sum(_block_bound_s(conv, arch._conv_flops, frames, members, dtype)
                for conv in arch.convs(ctx.config))
    return 100.0 * bound / seconds
