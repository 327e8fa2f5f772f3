"""Where the tensor-core kernels' time goes on the card, by removing one part.

    python3 tools/torch_mma_variants.py [--source {bf16,tf32,tiled,tiled_mma,res_chain,both}]
                                        [--stamps]

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

- ``tiled``, the same source's tiled forms (``conv_tiled_tf32_kernel``,
  ``split_weights_kernel``) at ``impala_128px``'s M = 16: the res stage at
  64 ch x 64x64 and 128 ch x 32x32, the feature pool 64 -> 128 at 64x64.
  Cuts: ``no_products`` (no ``mma.sync`` or ``wgmma``), ``no_transform``
  (the landed operand is not rewritten as its affine's hi and lo planes),
  ``no_store`` (no output written, so no epilogue); the bulk and tensor-map
  copies stay (the barriers their readers wait on complete only with them).
  The wrappers keep a weight tensor's split image between calls, so the
  variants' times leave the split out; ``base`` is timed once more with the
  image dropped before every call (``split_weights_kernel`` included).  Not
  cuts: ``res_mma_sync`` (the res stage's products on ``mma.sync``, warps
  of 32 channels x 32 positions, in place of ``wgmma``) and
  ``pool_whole_k`` (the pool's warps 16 channels x 40 positions with all
  of K, in place of 32 x 40 with K in halves).  Every variant's
  largest error against the plain version is printed beside its times.

- ``tiled_mma``, ``fused_resblock_mma.cu``'s tiled forms
  (``conv_tiled_mma_kernel``, ``round_weights_kernel``, bf16 on ``wgmma``)
  at 192-pixel frames' shapes: the res stage at 64 ch x 96x96 and 128 ch x
  48x48 (M = 16), the feature pool 64 -> 128 at 192x192 (M = 2).  Cuts:
  ``no_products`` (no ``wgmma``), ``no_transform`` (the landed operand is
  not rewritten as the bf16 planes), ``no_store`` (no output written, f32
  or planes); not a cut: ``ring2`` (two ring slots everywhere).  ``base`` is timed
  once more with the image rounded every call.

``--stamps`` builds the tiled source once more with ``%globaltimer`` read
at each phase of a chunk (the barrier, the copies' issue, the transform's
slices with the products, the epilogue) and prints their medians over the
res stage's blocks at ``impala_128px``'s two shapes; with ``--source
tiled_mma``, the bf16 tiled source's phases instead (``run_stamps_mma``:
the landing and weights waits, the products' issue, the transform, the
products' remainder, the barrier and the epilogue, at the three 192-pixel
shapes).

``both`` runs ``bf16`` and ``tf32``.  The difference between ``base`` and
a variant is what that part costs where it does not overlap the rest.  The
cuts compute wrong outputs.  A variant nvcc refuses is printed and left
out.  Times come
from ``time_ms`` (CUDA events, the calls queued behind a spin kernel),
beside the card's name and power limit.  Needs a CUDA device and ``nvcc``;
builds under ``build/dfd_tpu_torch/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

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


CSRC = Path(__file__).resolve().parents[1] / "dfd_tpu_torch" / "ops" / "csrc"


def build_variants(stem: str, srcs: dict) -> Path:
    """Compile each variant (a source's text, or its text and the headers it
    replaces) in a directory of its own beside copies of the shared headers,
    all nvcc processes at once; returns the directory of the libraries."""
    from dfd_tpu_torch.ops import build

    out = build.BUILD_DIR / "variants"
    procs = {}
    for name, variant in srcs.items():
        text, headers = variant if isinstance(variant, tuple) else (variant, {})
        d = out / f"{stem}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(headers.get(h.name, h.read_text()))
        (d / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{stem}_{name}.so"),
             str(d / f"{stem}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:  # printed and left out of the timings
            print(f"build: nvcc failed for the {stem} {name} variant:\n{log[-3000:]}", flush=True)
            continue
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        print(f"build: {stem} {name}: {spills} bytes of spill stores", flush=True)
    return out


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
RC_COPY = ("if (v == 4) cp_async16(d, src); else cp_async4(d, src);",)
RC_EXCHANGE = ("    if (cs > 1) {  // this block's channels", "    if (ry > 0) {  // the top halo",
               "    if (y0 + rows < H) {  // the bottom halo")
RC_K_LOOPS = ("    for (int k0 = 0; k0 < kp; k0 += 8) {", "    for (int k0 = 0; k0 < kp; k0 += 16) {")


def res_chain_variants(src: str) -> dict:
    return {
        "base": src,
        "no_products": _cut(src, *RC_PRODUCTS, new="{}"),
        "no_split": (src, {"ptx.cuh": _cut((CSRC / "ptx.cuh").read_text(), TF32_SPLIT,
                                           new="  hi = __float_as_uint(a);\n  lo = 0u;\n")}),
        "no_weight_copy": _cut(src, *RC_COPY, new="{}"),
        "no_exchange": _cut(_cut(_cut(src, RC_EXCHANGE[0], new=RC_EXCHANGE[0].replace("cs > 1", "false")),
                                  RC_EXCHANGE[1], new=RC_EXCHANGE[1].replace("ry > 0", "false")),
                             RC_EXCHANGE[2], new=RC_EXCHANGE[2].replace("y0 + rows < H", "false")),
        "unroll_k": _cut(src, *RC_K_LOOPS[:1], new="#pragma unroll 2\n" + RC_K_LOOPS[0])
        .replace(RC_K_LOOPS[1], "#pragma unroll 2\n" + RC_K_LOOPS[1]),
    }


def run_res_chain(dev: torch.device) -> None:
    """The res_chain variants at the wide probe's twelve cases."""
    import numpy as np

    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import res_chain as rc
    from dfd_tpu_torch.probes import wide
    from dfd_tpu_torch.utils.profiling import time_ms

    srcs = res_chain_variants((build.CSRC / "res_chain.cu").read_text())
    out = build_variants("res_chain", srcs)
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
    print("res_chain.cu, the wide probe's chains at P = 64")
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
    ptx = (CSRC / "ptx.cuh").read_text()
    return {
        "base": src,
        "no_products": _cut(src, *TF32_PRODUCTS, new="{}"),
        "no_split": (src, {"ptx.cuh": _cut(ptx, TF32_SPLIT,
                                           new="  hi = __float_as_uint(a);\n  lo = 0u;\n")}),
        "no_weight_copy": _cut(src, *TF32_COPY, new="{}"),
        "no_products_no_copy": _cut(_cut(src, *TF32_PRODUCTS, new="{}"), *TF32_COPY, new="{}"),
    }


TILED_PRODUCTS = ("mma_tf32(part[mt][n], alo[mt], bhi);", "mma_tf32(part[mt][n], ahi[mt], blo);",
                  "mma_tf32(part[mt][n], ahi[mt], bhi);", "wgmma_n72(d, alo, bhi, kh > 0);",
                  "wgmma_n72(d, ahi, blo, 1);", "wgmma_n72(d, ahi, bhi, 1);")
TILED_TRANSFORM = ("    for (int slice = 0; slice < kSlices; ++slice) transform_slice(a, tp, lbuf, pbuf, v, slice);\n",
                   "      transform_slice(a, tp, lbuf + ((k + 1) & 1) * lfl, pbuf + ((k + 1) & 1) * pfl, v, kw);\n")
TILED_RES_FORM = "kernel = &conv_tiled_tf32_kernel<1, 9, 2, false, true>;"
TILED_POOL_FORM = "kernel = &conv_tiled_tf32_kernel<2, 5, 2, true, false>;"
TILED_STORE = "a.out[(mb * a.co + co) * plane + goff[n][c2]] = u;"


MMA_TILED_PRODUCT = "wgmma_bf16_n152(acc, ad, bd, 1);"
MMA_TILED_TRANSFORM = (
    "    transform_chunk(a, m, 0, lbuf, pbuf, v);\n",
    "        transform_chunk(a, m, (k + 1) * tmma::kKc, lbuf + next * lfl,\n"
    "                        pbuf + ((k + 1) & 1) * pel, v);\n")
MMA_TILED_STORE = ("    if (a.out != nullptr) {\n", "    if (a.pout != nullptr) {\n")
MMA_TILED_RING = "const int stages = tmma::stages(POOL, planar, a.co, a.th, a.tw);"


def tiled_mma_variants(src: str) -> dict:
    return {
        "base": src,
        "no_products": _cut(src, MMA_TILED_PRODUCT, new="{}"),
        "no_transform": _cut(src, *MMA_TILED_TRANSFORM, new="{}\n"),
        "no_store": _cut(src, *MMA_TILED_STORE, new="    if (t[0][0] == 12345.f) {\n"),
        "ring2": _cut(src, MMA_TILED_RING, new="const int stages = 2;"),
    }


def tiled_variants(src: str) -> dict:
    return {
        "base": src,
        "res_mma_sync": _cut(src, TILED_RES_FORM,
                             new="kernel = &conv_tiled_tf32_kernel<2, 4, 2, false, false>;"),
        "pool_whole_k": _cut(src, TILED_POOL_FORM,
                             new="kernel = &conv_tiled_tf32_kernel<1, 5, 1, true, false>;"),
        "no_products": _cut(src, *TILED_PRODUCTS, new="{}"),
        "no_transform": _cut(src, *TILED_TRANSFORM, new="{}\n"),
        "no_store": _cut(src, TILED_STORE, new="if (u == 12345.f) a.out[0] = u;"),
    }


# source: (file, variants, loader attribute, entry points and their pointer
# and int arguments, compute_dtype, members, (kind, ci, co, H, W[, members]) cases)
SOURCES = {
    "bf16": ("fused_resblock_mma", bf16_variants, "_mma_kernels",
             (("dfd_res_stage_mma", 6, 7), ("dfd_feat_pool_mma", 6, 7)), torch.bfloat16, 65,
             [("res", 64, 64, 32, 32), ("res", 128, 128, 16, 16), ("feat", 64, 128, 32, 32),
              ("feat", 128, 128, 16, 16)]),
    "tf32": ("fused_resblock_tf32", tf32_variants, "_tf32_kernels",
             (("dfd_res_stage_tf32", 6, 8), ("dfd_feat_pool_tf32", 6, 8)), None, 129,
             [("res", 16, 16, 32, 32), ("res", 32, 32, 16, 16), ("feat", 16, 32, 32, 32),
              ("feat", 32, 32, 16, 16)]),
    "tiled": ("fused_resblock_tf32", tiled_variants, "_tf32_kernels",
              (("dfd_res_stage_tiled_tf32", 8, 8), ("dfd_feat_pool_tiled_tf32", 7, 9)), None, 16,
              [("res", 64, 64, 64, 64), ("feat", 64, 128, 64, 64), ("res", 128, 128, 32, 32)]),
    "tiled_mma": ("fused_resblock_mma", tiled_mma_variants, "_mma_kernels",
                  (("dfd_res_stage_tiled_mma", 8, 8), ("dfd_feat_pool_tiled_mma", 7, 9)),
                  torch.bfloat16, 16,
                  [("res", 64, 64, 96, 96), ("res", 128, 128, 48, 48), ("feat", 64, 128, 192, 192, 2)]),
}


def run(key: str, dev: torch.device) -> None:
    import chip_smoke
    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import fused_resblock as fr
    from dfd_tpu_torch.utils.profiling import time_ms

    stem, make, loader, entries, cd, M, cases = SOURCES[key]
    srcs = make((build.CSRC / f"{stem}.cu").read_text())
    out = build_variants(stem, srcs)
    inputs = [chip_smoke._fused_inputs(c[0], c[5] if len(c) > 5 else M, 1, *c[1:5], dev,
                                       seed=0)[0] for c in cases]
    wants = [(fr.fused_res_stage_plain if kind == "res" else fr.fused_feat_pool_plain)(
        *args, compute_dtype=cd) for (kind, *_), args in zip(cases, inputs)]
    print(f"{stem}.cu, M = {M}, one frame a member")
    print("variant              " + "  ".join(f"{c[0]} {c[1]}->{c[2]} {c[3]}x{c[4]} ms"
                                              for c in cases))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    original = getattr(fr, loader)
    try:
        for name in srcs:
            if not (out / f"lib{stem}_{name}.so").exists():
                continue
            lib = ctypes.CDLL(str(out / f"lib{stem}_{name}.so"))
            for entry, n_ptr, n_int in entries:
                getattr(lib, entry).argtypes = [vp] * n_ptr + [i32] * n_int + [vp]
                getattr(lib, entry).restype = i32
            setattr(fr, loader, lambda lib=lib: lib)  # the wrappers launch this variant
            row, errs, fresh = [], [], []
            for (kind, *_), args, want in zip(cases, inputs, wants):
                fn = fr.fused_res_stage if kind == "res" else fr.fused_feat_pool
                errs.append(((fn(*args, compute_dtype=cd) - want).abs().max()
                             / want.abs().max().clamp(min=1.0)).item())
                row.append(time_ms(lambda: fn(*args, compute_dtype=cd), dev, 20))
                if key.startswith("tiled") and name == "base":  # the image made every call
                    fresh.append(time_ms(lambda: (fr._IMAGES.clear(), fn(*args, compute_dtype=cd))[1],
                                         dev, 20))
            print(f"{name:20s} " + "  ".join(f"{ms:.4f}" for ms in row)
                  + "  (max|d| / scale " + ", ".join(f"{e:.3g}" for e in errs) + ")", flush=True)
            if fresh:
                print(f"{'base, image each call':20s} " + "  ".join(f"{ms:.4f}" for ms in fresh),
                      flush=True)
    finally:
        setattr(fr, loader, original)


# --stamps: %globaltimer read by two threads of each block (warp 0's and warp
# 15's first lanes) at the phases of a chunk, group 0's blocks of the last of
# the res stage's four launches
STAMP_DECL = """__device__ long long g_stamps[4096 * 2 * 64];
__device__ __forceinline__ void stamp(int i) {
  if ((threadIdx.x == 0 || threadIdx.x == 480) && blockIdx.x < 4096 && blockIdx.y == 0) {
    long long c;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c));
    g_stamps[(blockIdx.x * 2 + (threadIdx.x ? 1 : 0)) * 64 + i] = c;
  }
}
"""
STAMPS = (  # (text, stamp before it) in order; stamp i + 4k for chunk k
    ("  issue_weights(wbuf, wimg, G, &wbar[0]);\n", 0),
    ("                      // with chunk k - 1\n", 2),  # after: the barrier
    ("    // chunk k + 1's transform, a slice after each tap column of chunk k's products\n", 3),
    ("    const float* wst = wbuf + (k & 1) * wfl;\n", 4),
    ("  __syncthreads();  // every warp is done with the buffers, which are overlaid below\n", 60),
)


def stamped(src: str) -> str:
    """The source with STAMPS' clock reads and an entry that copies them out."""
    src = _cut(src, "template <int MT, int NT, int WK, bool POOL, bool WGMMA>\n__global__",
               new=STAMP_DECL + "template <int MT, int NT, int WK, bool POOL, bool WGMMA>\n__global__")
    for text, i in STAMPS:
        call = f"stamp({i}{' + 4 * k' if 0 < i < 60 else ''});\n"
        if i == 2:
            src = _cut(src, text, new=text + "    " + call)
        else:
            src = _cut(src, text, new=text[:len(text) - len(text.lstrip())] + call + text)
    return src + ("\nextern \"C\" int dfd_stamps(void* dst, size_t n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n")


def run_stamps(dev: torch.device) -> None:
    """Each phase's time a chunk, the median over the res stage's blocks (us)."""
    import numpy as np

    import chip_smoke
    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import fused_resblock as fr

    src = (build.CSRC / "fused_resblock_tf32.cu").read_text()
    out = build_variants("fused_resblock_tf32", {"stamps": stamped(src)})
    lib = ctypes.CDLL(str(out / "libfused_resblock_tf32_stamps.so"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_tiled_tf32.argtypes = [vp] * 8 + [i32] * 8 + [vp]
    lib.dfd_stamps.argtypes = [vp, ctypes.c_size_t]
    original = fr._tf32_kernels
    fr._tf32_kernels = lambda: lib
    try:
        for C, H, W in ((64, 64, 64), (128, 32, 32)):
            args = chip_smoke._fused_inputs("res", 16, 1, C, C, H, W, dev, seed=0)[0]
            for _ in range(3):
                fr.fused_res_stage(*args)
            torch.cuda.synchronize()
            st = np.zeros(4096 * 2 * 64, np.int64)
            assert lib.dfd_stamps(st.ctypes.data, st.nbytes) == 0
            nb = 16 * fr.res_stage_tf32_plan(C, H, W).tiles
            st = st.reshape(4096, 2, 64)[:nb].astype(np.float64) / 1e3
            d = lambda i, j, w=0: np.median(st[:, w, j] - st[:, w, i])
            nk = -(-C // 16)
            rows = [f"chunk {k}: issue {d(2 + 4 * k, 3 + 4 * k):.2f}, transform slices and "
                    f"products {d(4 + 4 * k, 2 + 4 * (k + 1) if k + 1 < nk else 60):.2f}"
                    for k in range(nk)]
            starts = np.sort(st[:, 0, 0] - st[:, 0, 0].min())
            print(f"stamps: res {C} ch @{H}x{W}, M = 16, the last launch's {nb} blocks: block "
                  f"{np.median(st[:, 0, 60] - st[:, 0, 0]):.2f} us from its start to its "
                  f"epilogue (prologue {d(0, 2):.2f}); " + "; ".join(rows)
                  + f"; the launch's blocks start over {starts[-1]:.2f} us", flush=True)
    finally:
        fr._tf32_kernels = original


# the bf16 tiled kernel's stamps: two threads of each block (warpgroup 0's and 3's first
# lanes), group 0's blocks of a launch (the res stage's last, a planar conv), 128 slots a
# thread: 0 the start, 1 chunk 0's transform done (f32 operand), 2 + 8k .. 7 + 8k chunk k's
# phases, 126 the loop's end, 127 the epilogue's.  f32 operand (the pool): after the
# barrier, the weights' wait, the products' issue, the next landing's wait, the next
# transform, the products' wait; planar: after the chunk's waits, its issue, the previous
# chunk's wait, the barrier and refill.
MMA_STAMP_DECL = """__device__ long long g_stamps[4096 * 2 * 128];
__device__ __forceinline__ void stamp(int i) {
  if ((threadIdx.x == 0 || threadIdx.x == 384) && blockIdx.x < 4096 && blockIdx.y == 0) {
    long long c;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c));
    g_stamps[(blockIdx.x * 2 + (threadIdx.x ? 1 : 0)) * 128 + i] = c;
  }
}
"""
MMA_STAMPS = (  # (text, code put after it)
    ("  const int gb = tmma::block_groups(a.co), spans = 4 / gb;\n", "  stamp(0);\n"),
    (MMA_TILED_TRANSFORM[0], "    stamp(1);\n"),
    ("                        // products; landing slot k % S is transformed\n",
     "      stamp(2 + 8 * k);\n"),
    ("      mbar_wait(&wbar[slot], (k / S) & 1);  // chunk k's weights are in\n",
     "      stamp(3 + 8 * k);\n"),
    ("                     n0, v.pa, v.tile_w);\n", "      stamp(4 + 8 * k);\n"),
    ("        if (a.vec) mbar_wait(&lbar[next], ((k + 1) / S) & 1);\n",
     "        stamp(5 + 8 * k);\n"),
    (MMA_TILED_TRANSFORM[1], "        stamp(6 + 8 * k);\n"),
    ("      }\n      wgmma_wait0();\n", "      stamp(7 + 8 * k);\n"),
    ("      mbar_wait(&wbar[slot], (k / S) & 1);\n", "      stamp(2 + 8 * k);\n"),
    ("      wgmma_wait1();  // chunk k - 1's products are done here\n", "      stamp(4 + 8 * k);\n"),
    ("        issue_planes(map, pbuf + (j % S) * pel, &lbar[j % S], v, plane0 + 2 * j);\n      }\n",
     "      stamp(5 + 8 * k);\n"),
)


def stamped_mma(src: str) -> str:
    """The bf16 tiled source with clock reads at MMA_STAMPS, and an entry
    that copies them out."""
    src = _cut(src, "template <bool POOL, int S, bool PLANAR>\n__global__",
               new=MMA_STAMP_DECL + "template <bool POOL, int S, bool PLANAR>\n__global__")
    for text, code in MMA_STAMPS:
        src = _cut(src, text, new=text + code)
    src = _cut(src, "                     v.pa, v.tile_w);\n      wgmma_wait1();",
               new="                     v.pa, v.tile_w);\n      stamp(3 + 8 * k);\n      wgmma_wait1();")
    src = _cut(src, "  __syncthreads();  // every warpgroup is done with the buffers\n",
               new="  stamp(126);\n  __syncthreads();  // every warpgroup is done with the buffers\n")
    src = _cut(src, "    return;\n  }\n  // the res stage's outputs",
               new="    stamp(127);\n    return;\n  }\n  // the res stage's outputs")
    src = _cut(src, "    res_epilogue<1>(a, sd, snt, rows, sstride, valid, mb, co0, v.oy, v.ox);\n}\n",
               new="    res_epilogue<1>(a, sd, snt, rows, sstride, valid, mb, co0, v.oy, v.ox);\n"
                   "  stamp(127);\n}\n")
    return src + ("\nextern \"C\" int dfd_stamps(void* dst, size_t n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n")


def run_stamps_mma(dev: torch.device) -> None:
    """Each phase's time in the bf16 tiled forms, summed over a block's
    chunks, the median over the launch's blocks (us)."""
    import numpy as np

    import chip_smoke
    from dfd_tpu_torch.ops import build
    from dfd_tpu_torch.ops import fused_resblock as fr

    src = (build.CSRC / "fused_resblock_mma.cu").read_text()
    out = build_variants("fused_resblock_mma", {"stamps": stamped_mma(src)})
    lib = ctypes.CDLL(str(out / "libfused_resblock_mma_stamps.so"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_tiled_mma.argtypes = [vp] * 8 + [i32] * 8 + [vp]
    lib.dfd_feat_pool_tiled_mma.argtypes = [vp] * 7 + [i32] * 9 + [vp]
    lib.dfd_stamps.argtypes = [vp, ctypes.c_size_t]
    original = fr._mma_kernels
    fr._mma_kernels = lambda: lib
    try:
        for kind, M, ci, co, H, W in (("res", 16, 64, 64, 96, 96), ("res", 16, 128, 128, 48, 48),
                                      ("feat", 2, 64, 128, 192, 192)):
            args = chip_smoke._fused_inputs(kind, M, 1, ci, co, H, W, dev, seed=0)[0]
            fn = fr.fused_res_stage if kind == "res" else fr.fused_feat_pool
            plan = (fr.res_stage_mma_plan(ci, H, W) if kind == "res"
                    else fr.feat_pool_mma_plan(ci, co, H, W))
            for _ in range(3):
                fn(*args, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            st = np.zeros(4096 * 2 * 128, np.int64)
            assert lib.dfd_stamps(st.ctypes.data, st.nbytes) == 0
            nb = M * plan.tiles
            st = st.reshape(4096, 2, 128)[:nb, 0].astype(np.float64) / 1e3
            nk = -(-ci // 16)
            d = lambda i, j: st[:, j] - st[:, i]
            if kind == "res":  # the last conv: a planar operand
                phase = dict.fromkeys(("operand and weights wait", "issue",
                                       "previous chunk's wait", "barrier and refill"), 0)
                for k in range(nk):
                    b = 2 + 8 * k
                    if k > 0:  # (chunk 0's wait is in the block's time only)
                        phase["operand and weights wait"] = phase["operand and weights wait"] + d(
                            b - 3, b)
                    phase["issue"] = phase["issue"] + d(b, b + 1)
                    phase["previous chunk's wait"] = phase["previous chunk's wait"] + d(b + 1, b + 2)
                    phase["barrier and refill"] = phase["barrier and refill"] + d(b + 2, b + 3)
                phase["last chunk's wait"] = d(8 * nk - 3, 126)
            else:
                phase = dict.fromkeys(("barrier", "weights wait", "products issue", "landing wait",
                                       "transform", "products wait"), 0)
                for k in range(nk):
                    b = 2 + 8 * k
                    phase["barrier"] = phase["barrier"] + d(1 if k == 0 else b - 3, b)
                    phase["weights wait"] = phase["weights wait"] + d(b, b + 1)
                    phase["products issue"] = phase["products issue"] + d(b + 1, b + 2)
                    if k + 1 < nk:
                        phase["landing wait"] = phase["landing wait"] + d(b + 2, b + 3)
                        phase["transform"] = phase["transform"] + d(b + 3, b + 4)
                        phase["products wait"] = phase["products wait"] + d(b + 4, b + 5)
                    else:
                        phase["products wait"] = phase["products wait"] + d(b + 2, b + 5)
            rows = [f"{k} {np.median(v):.2f}" for k, v in phase.items()]
            starts = np.sort(st[:, 0] - st[:, 0].min())
            print(f"stamps: bf16 {kind} {ci}->{co} @{H}x{W}, M = {M}, the last launch's {nb} blocks, "
                  f"medians (us): block {np.median(d(0, 127)):.2f}: prologue (chunk 0 landed and "
                  f"transformed) {np.median(d(0, 1)):.2f}; over its {nk} chunks: " + ", ".join(rows)
                  + f"; epilogue {np.median(d(126, 127)):.2f}; the launch's blocks start over "
                  f"{starts[-1]:.2f} us", flush=True)
    finally:
        fr._mma_kernels = original


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", choices=("bf16", "tf32", "tiled", "tiled_mma", "res_chain", "both"),
                    default="both")
    ap.add_argument("--stamps", action="store_true",
                    help="also time the tiled res stage's phases with clock stamps")
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
    if args.stamps:
        (run_stamps_mma if args.source == "tiled_mma" else run_stamps)(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
