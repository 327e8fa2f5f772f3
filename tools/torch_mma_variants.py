"""Where the tensor-core kernels' time goes on the card, by removing one part.

    python3 tools/torch_mma_variants.py [--source {bf16,tf32,res_chain,both}]

Builds each tensor-core source as it is and in variants, each with one part
of the work taken out of the source text, and times every variant's res
stage and feature pool at its main path's rollout shapes:

- ``bf16``, ``dfd_tpu_torch/ops/csrc/fused_resblock_mma.cu``
  (``res_stage_mma_kernel``, ``feat_pool_mma_kernel``) at
  ``impala_prod_bf16``'s M = 65 members, one frame each: the res stage at
  64 ch x 32x32 and 128 ch x 16x16, the feature pool 64 -> 128 at 32x32 and
  128 -> 128 at 16x16.  Variants: ``no_products`` (no ``mma.sync``; the
  ldmatrix loads stay), ``no_weight_copy`` (the weight taps are not copied
  in; their rounding and the products run on whatever the staging buffer
  holds), ``no_rounding`` (the staged taps are not rounded into the bf16
  tile), ``no_products_no_copy`` (neither);
- ``tf32``, ``dfd_tpu_torch/ops/csrc/fused_resblock_tf32.cu``
  (``res_stage_tf32_kernel``, ``feat_pool_tf32_kernel``, f32 operands as
  3xTF32 products) at ``impala_procmaze``'s M = 129: the res stage at 16 ch
  x 32x32 and 32 ch x 16x16, the feature pool 16 -> 32 at 32x32 and
  32 -> 32 at 16x16.  Variants: ``no_products`` (none of the three
  ``mma.sync`` a product, and with them the fragment loads and splits,
  which the compiler drops once nothing reads them), ``no_split``
  (no hi/lo split: each operand goes to the products as it is, lo = 0),
  ``no_weight_copy`` (the weight groups are not copied in),
  ``no_products_no_copy`` (neither);
- ``res_chain``, ``dfd_tpu_torch/ops/csrc/res_chain.cu`` (the probes'
  chain, f32 as 3xTF32 and bf16) at the wide probe's twelve cases (P = 64):
  ``no_products`` (no ``mma.sync``), ``no_split`` (f32: no hi/lo split),
  ``no_weight_copy``, ``no_exchange`` (no copy of a block's channels into
  its band's other blocks and no halo rows: the cluster's blocks still
  meet at every barrier), and ``unroll_k`` (not a cut: the K loop of the
  products unrolled by 2, so the next step's loads are issued before this
  step's products).

``both`` runs ``bf16`` and ``tf32``.  The difference between ``base`` and
a variant is what that part costs where it does not overlap the rest.  The
variants compute wrong outputs; only their times are printed.  Times come
from ``time_ms`` (CUDA events, the calls queued behind a spin kernel),
beside the card's name and power limit.  Needs a CUDA device and ``nvcc``;
builds under ``build/dfd_tpu_torch/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

BF16_PRODUCT = ("mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], "
                "b[nt >> 1][(nt & 1) * 2 + 1]);")
BF16_COPY = ("cp_async16(stage + r * ci + c, src + r * ldw + c);",
             "cp_async4(stage + r * ci + c, src + r * ldw + c);")
BF16_ROUND = "  for (int r = warp; r < mp; r += kWarps) {\n    if ((ci & 3) == 0) {"
TF32_PRODUCTS = ("mma_tf32(part[mt][u], alo[mt], bhi[u]);",
                 "mma_tf32(part[mt][u], ahi[mt], blo[u]);",
                 "mma_tf32(part[mt][u], ahi[mt], bhi[u]);")
TF32_SPLIT = ("  hi = to_tf32(a) & 0xffffe000u;  // the low 13 bits of a TF32 value are zero\n"
              "  lo = to_tf32(__fsub_rn(a, __uint_as_float(hi)));\n")
TF32_COPY = ("cp_async16(dst + r * csw + tap * kp + c, src + (size_t)r * 9 * ci + tap * ci + c);",
             "cp_async4(dst + r * csw + tap * kp + c, src + (size_t)r * 9 * ci + tap * ci + c);")


def _cut(src: str, *olds: str, new: str = "") -> str:
    for old in olds:
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old!r}: update the variants")
        src = src.replace(old, new)
    return src


def bf16_variants(src: str) -> dict:
    return {
        "base": src,
        "no_products": _cut(src, BF16_PRODUCT, new="{}"),
        "no_weight_copy": _cut(src, *BF16_COPY, new="{}"),
        "no_rounding": _cut(src, BF16_ROUND, new=BF16_ROUND.replace("r < mp", "r < 0")),
        "no_products_no_copy": _cut(_cut(src, BF16_PRODUCT, new="{}"), *BF16_COPY, new="{}"),
    }


RC_PRODUCTS = ("mma_tf32_zero(part[mt][u], alo[mt], bhi[u]);",
               "mma_tf32(part[mt][u], ahi[mt], blo[u]);",
               "mma_tf32(part[mt][u], ahi[mt], bhi[u]);",
               "mma_bf16(acc[mt][n], a[mt], b0, b1);")
RC_SPLIT = ("  hi = to_tf32(a) & 0xffffe000u;\n"
            "  lo = to_tf32(__fsub_rn(a, __uint_as_float(hi)));\n")
RC_COPY = ("if (v == 4) cp_async16(d, src); else cp_async4(d, src);",)
RC_EXCHANGE = ("    if (cs > 1) {  // this block's channels", "    if (ry > 0) {  // the top halo",
               "    if (y0 + rows < H) {  // the bottom halo")
RC_K_LOOPS = ("    for (int k0 = 0; k0 < kp; k0 += 8) {", "    for (int k0 = 0; k0 < kp; k0 += 16) {")


def res_chain_variants(src: str) -> dict:
    return {
        "base": src,
        "no_products": _cut(src, *RC_PRODUCTS, new="{}"),
        "no_split": _cut(src, RC_SPLIT, new="  hi = __float_as_uint(a);\n  lo = 0u;\n"),
        "no_weight_copy": _cut(src, *RC_COPY, new="{}"),
        "no_exchange": _cut(_cut(_cut(src, RC_EXCHANGE[0], new=RC_EXCHANGE[0].replace("cs > 1", "false")),
                                  RC_EXCHANGE[1], new=RC_EXCHANGE[1].replace("ry > 0", "false")),
                             RC_EXCHANGE[2], new=RC_EXCHANGE[2].replace("y0 + rows < H", "false")),
        "unroll_k": _cut(src, *RC_K_LOOPS[:1], new="#pragma unroll 2\n" + RC_K_LOOPS[0])
        .replace(RC_K_LOOPS[1], "#pragma unroll 2\n" + RC_K_LOOPS[1]),
    }


def run_res_chain(dev: torch.device) -> None:
    """The res_chain variants at the wide probe's twelve cases."""
    import re

    import numpy as np

    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import res_chain as rc
    from dfd_tpu_torch.probes import wide
    from dfd_tpu_torch.utils.profiling import time_ms

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = res_chain_variants((build.CSRC / "res_chain.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        (out / f"res_chain_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"libres_chain_{name}.so"),
             str(out / f"res_chain_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the res_chain {name} variant:\n{logs[name]}")
    cases = []
    for C, H, W in wide.STAGES:
        rng = np.random.RandomState(2)
        xs = torch.from_numpy(rng.randn(64, C, H * W).astype(np.float32) * 0.1).to(dev)
        ws = torch.from_numpy(rng.randn(64, 4, C, C * 9).astype(np.float32) * 0.02).to(dev)
        bs = torch.from_numpy(rng.randn(64, 4, C).astype(np.float32) * 0.01).to(dev)
        for layout in ("channel_major", "channel_minor"):
            minor = layout == "channel_minor"
            x = xs.transpose(1, 2).contiguous() if minor else xs
            w = ws.transpose(2, 3).contiguous() if minor else ws
            for tag, cd in wide.DTYPES:
                cases.append((f"{C}ch {layout[8:]} {tag}", x, w, bs, H, W, layout, cd))
    spills = {k: sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", v))
              for k, v in logs.items()}
    print("res_chain.cu, the wide probe's chains at P = 64; bytes of spill stores: "
          + ", ".join(f"{k} {n}" for k, n in spills.items()))
    print("variant         " + "  ".join(c[0] for c in cases))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    original = rc._kernels
    try:
        for name in srcs:
            lib = ctypes.CDLL(str(out / f"libres_chain_{name}.so"))
            lib.dfd_res_chain.argtypes = [vp] * 4 + [i32] * 15 + [vp]
            lib.dfd_res_chain.restype = i32
            rc._kernels = lambda lib=lib: lib  # the wrapper launches this variant
            row = [time_ms(lambda: rc.res_chain(x, w, b, H, W, layout, cd), dev, 10)
                   for _, x, w, b, H, W, layout, cd in cases]
            print(f"{name:15s} " + "  ".join(f"{ms:.4f}" for ms in row) + f"  sum {sum(row):.4f}",
                  flush=True)
    finally:
        rc._kernels = original


def tf32_variants(src: str) -> dict:
    return {
        "base": src,
        "no_products": _cut(src, *TF32_PRODUCTS, new="{}"),
        "no_split": _cut(src, TF32_SPLIT, new="  hi = __float_as_uint(a);\n  lo = 0u;\n"),
        "no_weight_copy": _cut(src, *TF32_COPY, new="{}"),
        "no_products_no_copy": _cut(_cut(src, *TF32_PRODUCTS, new="{}"), *TF32_COPY, new="{}"),
    }


# source: (file, variants, loader attribute, entry points and their int
# arguments, compute_dtype, members, (kind, ci, co, H, W) cases)
SOURCES = {
    "bf16": ("fused_resblock_mma", bf16_variants, "_mma_kernels",
             (("dfd_res_stage_mma", 7), ("dfd_feat_pool_mma", 7)), torch.bfloat16, 65,
             [("res", 64, 64, 32, 32), ("res", 128, 128, 16, 16), ("feat", 64, 128, 32, 32),
              ("feat", 128, 128, 16, 16)]),
    "tf32": ("fused_resblock_tf32", tf32_variants, "_tf32_kernels",
             (("dfd_res_stage_tf32", 8), ("dfd_feat_pool_tf32", 8)), None, 129,
             [("res", 16, 16, 32, 32), ("res", 32, 32, 16, 16), ("feat", 16, 32, 32, 32),
              ("feat", 32, 32, 16, 16)]),
}


def run(key: str, dev: torch.device) -> None:
    import chip_smoke
    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import fused_resblock as fr
    from dfd_tpu_torch.utils.profiling import time_ms

    stem, make, loader, entries, cd, M, cases = SOURCES[key]
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = make((build.CSRC / f"{stem}.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        (out / f"{stem}_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{stem}_{name}.so"),
             str(out / f"{stem}_{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {stem} {name} variant:\n{log}")
    inputs = [chip_smoke._fused_inputs(kind, M, 1, ci, co, H, W, dev, seed=0)[0]
              for kind, ci, co, H, W in cases]
    print(f"{stem}.cu, M = {M}, one frame a member")
    print("variant              " + "  ".join(f"{k} {ci}->{co} {H}x{W} ms"
                                              for k, ci, co, H, W in cases))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    original = getattr(fr, loader)
    try:
        for name in srcs:
            lib = ctypes.CDLL(str(out / f"lib{stem}_{name}.so"))
            for entry, n_int in entries:
                getattr(lib, entry).argtypes = [vp] * 6 + [i32] * n_int + [vp]
                getattr(lib, entry).restype = i32
            setattr(fr, loader, lambda lib=lib: lib)  # the wrappers launch this variant
            row = []
            for (kind, *_), args in zip(cases, inputs):
                fn = fr.fused_res_stage if kind == "res" else fr.fused_feat_pool
                row.append(time_ms(lambda: fn(*args, compute_dtype=cd), dev, 20))
            print(f"{name:20s} " + "  ".join(f"{ms:.4f}" for ms in row), flush=True)
    finally:
        setattr(fr, loader, original)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", choices=("bf16", "tf32", "res_chain", "both"),
                    default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mma_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    print(chip_smoke.card_line())
    for key in ("bf16", "tf32") if args.source == "both" else (args.source,):
        if key == "res_chain":
            run_res_chain(torch.device("cuda"))
        else:
            run(key, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
