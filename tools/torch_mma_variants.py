"""Where the bf16 torso kernels' time goes on the card, by removing one part.

    python3 tools/torch_mma_variants.py

Builds ``dfd_tpu_torch/ops/csrc/fused_resblock_mma.cu`` as it is and in
variants, each with one part of the work taken out of the source text, and
times every variant's ``res_stage_mma_kernel`` and ``feat_pool_mma_kernel``
at ``impala_prod_bf16``'s rollout shapes (M = 65 members, one frame each:
the res stage at 64 ch x 32x32 and 128 ch x 16x16, the feature pool
64 -> 128 at 32x32 and 128 -> 128 at 16x16):

- ``base``: the source as it is;
- ``no_products``: no ``mma.sync`` (the ldmatrix loads stay);
- ``no_weight_copy``: the weight taps are not copied in (their rounding and
  the products run on whatever the staging buffer holds);
- ``no_rounding``: the staged taps are not rounded into the bf16 tile;
- ``no_products_no_copy``: neither, leaving the staging of the activations,
  the barriers, the epilogues and the launch.

The difference between ``base`` and a variant is what that part costs
where it does not overlap the rest.  The variants compute wrong outputs;
only their times are printed.  Times come from ``time_ms`` (CUDA events,
the calls queued behind a spin kernel), beside the card's name and power
limit.  Needs a CUDA device and ``nvcc``; builds under
``build/dfd_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

PRODUCT = ("mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], "
           "b[nt >> 1][(nt & 1) * 2 + 1]);")
COPY = ("cp_async16(stage + r * ci + c, src + r * ldw + c);",
        "cp_async4(stage + r * ci + c, src + r * ldw + c);")
ROUND = "  for (int r = warp; r < mp; r += kWarps) {\n    if ((ci & 3) == 0) {"
# (kind, ci, co, H, W) at M = 65, B = 1
CASES = [("res", 64, 64, 32, 32), ("res", 128, 128, 16, 16), ("feat", 64, 128, 32, 32),
         ("feat", 128, 128, 16, 16)]


def _cut(src: str, *olds: str, new: str = "") -> str:
    for old in olds:
        if old not in src:
            raise RuntimeError(f"fused_resblock_mma.cu no longer holds {old!r}: update the variants")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    no_round = _cut(src, ROUND, new=ROUND.replace("r < mp", "r < 0"))
    return {
        "base": src,
        "no_products": _cut(src, PRODUCT, new="{}"),
        "no_weight_copy": _cut(src, *COPY, new="{}"),
        "no_rounding": no_round,
        "no_products_no_copy": _cut(_cut(src, PRODUCT, new="{}"), *COPY, new="{}"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import fused_resblock as fr
    from dfd_tpu_torch.utils.profiling import time_ms

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "fused_resblock_mma.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    dev = torch.device("cuda")
    print(chip_smoke.card_line())
    inputs = [chip_smoke._fused_inputs(kind, 65, 1, ci, co, H, W, dev, seed=0)[0]
              for kind, ci, co, H, W in CASES]
    print("variant              " + "  ".join(f"{k} {ci}->{co} {H}x{W} ms"
                                              for k, ci, co, H, W in CASES))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in srcs:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.dfd_res_stage_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
        lib.dfd_res_stage_mma.restype = i32
        lib.dfd_feat_pool_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
        lib.dfd_feat_pool_mma.restype = i32
        fr._mma_kernels = lambda lib=lib: lib  # the wrappers launch this variant
        row = []
        for (kind, *_), args in zip(CASES, inputs):
            fn = fr.fused_res_stage if kind == "res" else fr.fused_feat_pool
            row.append(time_ms(lambda: fn(*args, compute_dtype=torch.bfloat16), dev, 20))
        print(f"{name:20s} " + "  ".join(f"{ms:.4f}" for ms in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
