"""Hopper probe of the fused residual-conv chain at production widths: the
counterpart of ``tools/probe_pallas_wide.py``.

    python -m dfd_tpu_torch.probes.wide [P]

For each of the TPU probe's stages, 128 channels at 16x16, 64 at 32x32 and
the 16-channel control at 32x32, with P members (64 by default) on
``RandomState(2)`` inputs: the chain ``x <- x + 0.25 relu(W_j pat(x) + b_j)``,
four convs, through :func:`dfd_tpu_torch.ops.res_chain.res_chain` in both
layouts (channel-major, the TPU probe's N-major, and channel-minor, its
M-major) with f32 and bf16 operands.  Beside each: its plain version (rolls
and masks, as the TPU kernel builds the taps), and the library route, the
probe's "XLA production lowering": patches then one batched product per
conv, as the port's ``conv_impl="patches"`` builds them
(:func:`patches_chain`), on the channel-major inputs.  Each row gives the
kernel's bound (f32: as 3xTF32 tensor-core products at 165 TFLOP/s, and on
the CUDA cores at 67, ``cuda_core_bound_ms``; bf16 at 989), its ratio to
the library route and its launch plan.  The same chain as
grouped ``F.conv2d`` calls (:func:`conv2d_chain`) is timed too; in f32 it is
checked, in bf16 its operands and outputs are bf16 tensors (cuDNN rounds each
conv's output), so it is timed only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from dfd_tpu_torch.models.impala import conv3x3_patches
from dfd_tpu_torch.ops.res_chain import res_chain, res_chain_plain, res_chain_plan
from dfd_tpu_torch.probes import _common as c
from dfd_tpu_torch.utils.profiling import BF16_RATE, BYTES_RATE, F32_RATE, TF32X3_RATE, time_ms

# (C, H, W): tools/probe_pallas_wide.py::main, in its order
STAGES = ((128, 16, 16), (64, 32, 32), (16, 32, 32))
N_CONVS = 4
DTYPES = (("f32", None), ("bf16", torch.bfloat16))


def oihw(w: torch.Tensor) -> torch.Tensor:
    """[P, J, C, 9C] weights in the taps' (dx, dy, c) order -> OIHW
    [P, J, C, C, 3, 3]."""
    P, J, C = w.shape[:3]
    return w.reshape(P, J, C, 3, 3, C).permute(0, 1, 2, 5, 4, 3).contiguous()


def patches_chain(x, w4, b, H: int, W: int, compute_dtype=None) -> torch.Tensor:
    """The chain on channel-major x [P, C, S], w4 = :func:`oihw` of the
    weights: each conv as patches + one batched product per member."""
    P, C, S = x.shape
    h = x.view(P, 1, C, H, W)
    for j in range(w4.shape[1]):
        y = conv3x3_patches({"w": w4[:, j], "b": b[:, j]}, h, compute_dtype)
        h = h + torch.relu(y) * 0.25
    return h.reshape(P, C, S)


def conv2d_chain(x, w4, b, H: int, W: int) -> torch.Tensor:
    """The chain as grouped ``F.conv2d`` calls over the members, in the
    operands' dtype."""
    P, C, S = x.shape
    h = x.reshape(1, P * C, H, W)
    for j in range(w4.shape[1]):
        y = F.conv2d(h, w4[:, j].reshape(P * C, C, 3, 3), b[:, j].reshape(-1), padding=1,
                     groups=P)
        h = h + torch.relu(y) * 0.25
    return h.reshape(P, C, S)


def chain_cost(P: int, J: int, C: int, S: int):
    """(FLOPs, bytes) of a chain: the conv FMAs (2 FLOPs each) and the bias,
    relu, scale and add; x in and out, the weights and biases once."""
    flops = float(P) * J * (2 * S * C * 9 * C + 4 * S * C)
    nbytes = 4.0 * (2 * P * C * S + P * J * 9 * C * C + P * J * C)
    return flops, nbytes


def chain_rows(probe: str, xs: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor, H: int,
               W: int, variants, dev: torch.device, n: int) -> list:
    """The chain on channel-major ``xs [P, C, S]``, ``ws [P, J, C, 9C]``,
    ``bs [P, J, C]`` for each (tag, layout, compute dtype) of ``variants``,
    each beside the patches route of its dtype (checked) and the conv2d
    route's time."""
    P, C, S = xs.shape
    J = ws.shape[1]
    xs_m = xs.transpose(1, 2).contiguous()
    ws_m = ws.transpose(2, 3).contiguous()
    w4 = oihw(ws)
    w4_bf16, b_bf16, x_bf16 = w4.to(torch.bfloat16), bs.to(torch.bfloat16), xs.to(torch.bfloat16)
    flops, nbytes = chain_cost(P, J, C, S)
    conv_ms = {}
    rows = []
    for tag, layout, cd in variants:
        x, w = (xs_m, ws_m) if layout == "channel_minor" else (xs, ws)
        tol = c.TOL_F32 if cd is None else c.TOL_BF16
        case = f"fused {layout} {tag} {J}x res-conv {C}ch@{H}x{W} P={P}"
        plain = lambda: res_chain_plain(x, w, bs, H, W, layout, cd)
        library = lambda: patches_chain(xs, w4, bs, H, W, cd)
        want = plain()
        lib = library()
        if layout == "channel_minor":
            lib = lib.transpose(1, 2)
        c.check_match(f"{probe}: {case}: patches route", lib, want, tol)
        if cd not in conv_ms:
            if cd is None:
                conv = lambda: conv2d_chain(xs, w4, bs, H, W)
                c.check_match(f"{probe}: {case}: conv2d route", conv(),
                              res_chain_plain(xs, ws, bs, H, W, "channel_major"), tol)
            else:
                conv = lambda: conv2d_chain(x_bf16, w4_bf16, b_bf16, H, W)
            conv_ms[cd] = time_ms(conv, dev, n)
        # a bf16 chain must also sit nearer its bf16 plain version than the f32 one
        other = None if cd is None else (lambda: res_chain_plain(x, w, bs, H, W, layout, None))
        row = c.measure(probe, case, "res_chain",
                        lambda: res_chain(x, w, bs, H, W, layout, cd), plain, tol=tol,
                        flops=flops, rate=TF32X3_RATE if cd is None else BF16_RATE,
                        nbytes=nbytes, dev=dev, n=n, library=library, other=other)
        if cd is None:  # f32: bound_ms as 3xTF32 products, and on the CUDA cores
            row["cuda_core_bound_ms"] = max(flops / F32_RATE, nbytes / BYTES_RATE) * 1e3
        row["vs_library"] = row["ms"] / row["library_ms"]
        p = res_chain_plan(P, C, H, W, layout, cd is not None)
        row["plan"] = (f"{p.rs} bands x {p.cs} channel groups, {P * p.rs * p.cs} blocks, "
                       f"taps by {p.wt}")
        row["conv2d_ms"] = conv_ms[cd]
        row["tflops"] = 2.0 * P * J * S * C * 9 * C / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
    return rows


def probe_stage(P: int, C: int, H: int, W: int, dev: torch.device, n: int = 20) -> list:
    """One stage of the TPU probe: its inputs, both layouts, both types."""
    S = H * W
    rng = np.random.RandomState(2)
    xs = torch.from_numpy(rng.randn(P, C, S).astype(np.float32) * 0.1).to(dev)
    ws = torch.from_numpy(rng.randn(P, N_CONVS, C, C * 9).astype(np.float32) * 0.02).to(dev)
    bs = torch.from_numpy(rng.randn(P, N_CONVS, C).astype(np.float32) * 0.01).to(dev)
    variants = [(tag, layout, cd) for layout in ("channel_major", "channel_minor")
                for tag, cd in DTYPES]
    return chain_rows("wide", xs, ws, bs, H, W, variants, dev, n)


def run(device=None, P: int = 64, stages=STAGES, n: int = 20) -> list:
    """Every stage of ``stages`` ((C, H, W) tuples) at ``P`` members."""
    dev = c.probe_device(device)
    rows = []
    for C, H, W in stages:
        rows += probe_stage(P, C, H, W, dev, n)
    return rows


def main() -> int:
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    c.print_rows(run(P=P))
    return 0


if __name__ == "__main__":
    sys.exit(main())
