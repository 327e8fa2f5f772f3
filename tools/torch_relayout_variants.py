"""What the transpose and concat kernels' designs give, on one card: variants
of ``dfd_tpu_torch/ops/csrc/relayout.cu`` at the probes' and production sizes.

    python3 tools/torch_relayout_variants.py [--kernels transpose concat] [--out FILE]

Builds copies of this checkout's ``relayout.cu`` with the same ``nvcc``
flags as ``dfd_tpu_torch/ops/build.py``, into ``build/relayout_variants/``
(``--kernels`` picks the kernels timed, both by default, and only their
copies are built).  For the transpose, each with the entry's refusal of
another plan taken out of its text, so that it runs the plan it is given:

- ``anyplan``: the kernel as it is;
- ``one stage``: the ring cut to one stage: a tile's loads are issued after
  the previous tile's stores and waited for at once, so a block never has
  loads in flight while it stores;
- ``tma``: the loads by the Tensor Memory Accelerator
  (``cp.async.bulk.tensor.2d`` of a ``tr x 32`` box into a stage in the
  128-byte swizzle, an ``mbarrier`` a stage, one thread issuing them; the
  tensor map from ``cuTensorMapEncodeTiled``, reached through
  ``cudaGetDriverEntryPoint``), the same two-stage ring and float4 stores;
  its tiles are 32 columns wide (the swizzle's span), ``tr`` rows (128, or
  x's rows where fewer), its grid as the kernel's (at most ``MAX_BLOCKS``).

For the concat, each with one choice of its design changed in the text
(the copy's own plan, which its entry enforces, follows from it):

- ``swapped stores``: the float4 stores plain and the scalar ones
  evict-first (``__stcs``), the kernel's choice the other way round;
- ``128 threads``, ``512 threads``: blocks of that size, not 256;
- ``2 units``, ``4 units``: that many units a thread, ``kCatThreads``
  apart, all loaded before any store, not one.

Then each production transpose of ``x [33280, 1024]`` f32 (136 MB; seen as
``[33280, 1024]``, ``[64, 532480]``, ``[532480, 64]``, ``[16, 2129920]``,
``[2129920, 16]``, as in ``chip_smoke.py``) is held bit for bit to
``t().contiguous()`` in every variant and timed (``time_ms``, 20 calls) in
four rounds, forward and backward: the wrapper (the plan ``transpose_plan``
picks), ``one stage`` and ``tma`` at their plans, ``anyplan`` at every tile
shape of 4096 elements (16 x 256 to 256 x 16) and grids of 264 to 4224
blocks (2 to 32 an SM; 4 of 256 threads stay resident), and beside them
``clone`` of x (a flat copy of the same bytes).
Then the pool probe's transposes, ``[16, 4096]`` (``RandomState(0)``) and
``[48, 1024]`` (``RandomState(1)``), where a launch's latency decides: the
wrapper and ``anyplan`` at every tile of 256, 1024 and 4096 elements, one
tile a block, in eight rounds.

The concat's cases: ``x [33280, 1024]`` by 3 and by 8 scales, the ragged
``x.view(-1)[1:]`` by 3 (four rounds), and the probe's ``x [128, 1024]``
by 3 (eight rounds), each held bit for bit to ``torch.cat`` of the k
products and timed: the wrapper and every copy above, beside the plain
``torch.cat`` and one broadcasting multiply
(``probes/torso.py::concat_library``).  Prints one line a case and writes
them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dfd_tpu_torch.ops import build  # noqa: E402
from dfd_tpu_torch.ops import relayout as rl  # noqa: E402
from dfd_tpu_torch.probes.torso import concat_library  # noqa: E402
from dfd_tpu_torch.utils.profiling import BYTES_RATE, time_ms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (33280, 1024)
TRANSPOSES = ((33280, 1024), (64, 532480), (532480, 64), (16, 2129920), (2129920, 16))
TILES = ((16, 256), (32, 128), (64, 64), (128, 32), (256, 16))
GRIDS = (264, 528, 1056, 2112, 4224)
PROBE_TILES = ((16, 16), (16, 64), (32, 32), (64, 16), (16, 256), (64, 64), (256, 16))
# (name, x's shape, scales, x.view(-1)[1:]), and the rounds each is timed in
CONCATS = (("x [33280, 1024] k=3", SHAPE, 3, False, 4), ("x [33280, 1024] k=8", SHAPE, 8, False, 4),
           ("x.view(-1)[1:] of [33280, 1024] k=3", SHAPE, 3, True, 4),
           ("probe x [128, 1024] k=3", (128, 1024), 3, False, 8))
PUTS = ("void put(float4* p, float4 v) { __stcs(p, v); }",
        "void put(float* p, float v) { *p = v; }")
CAT_THREADS = "constexpr int kCatThreads = 256;"
# the kernel's body and plan, one unit a thread, and the same with V units a thread
CAT_BODY = """  const U units = (U)a.units, j = (U)blockIdx.x * kCatThreads + threadIdx.x;
  if (j >= units) return;
  const T v = __ldg(reinterpret_cast<const T*>(x) + j);
  T* os = reinterpret_cast<T*>(out);
  U o = j;  // this thread's unit in segment s
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s == a.k) break;
    put(os + o, mul(v, a.s.v[s]));
    o += units;
  }
"""
CAT_BODY_UNITS = """  constexpr int V = UNITS;
  const U units = (U)a.units, j0 = (U)blockIdx.x * (kCatThreads * V) + threadIdx.x;
  const T* xs = reinterpret_cast<const T*>(x);
  T* os = reinterpret_cast<T*>(out);
  T v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if (j0 + u * kCatThreads < units) v[u] = __ldg(xs + (j0 + u * kCatThreads));
  }
  U o = j0;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s == a.k) break;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (j0 + u * kCatThreads < units) put(os + (o + u * kCatThreads), mul(v[u], a.s.v[s]));
    }
    o += units;
  }
"""
CAT_GRID = "p.grid = (int)cdiv(n / p.width, kCatThreads);"


def cat_units(units: int) -> tuple:
    """The replacements that give each concat thread ``units`` units."""
    return ((CAT_BODY, CAT_BODY_UNITS.replace("UNITS", str(units))),
            (CAT_GRID, CAT_GRID.replace("kCatThreads)", f"kCatThreads * {units})")))


# the concat's copies: (name, replacements, threads a block, units a thread)
CAT_COPIES = (
    ("swapped stores", ((PUTS[0], PUTS[0].replace("__stcs(p, v);", "*p = v;")),
                        (PUTS[1], PUTS[1].replace("*p = v;", "__stcs(p, v);"))), 256, 1),
    ("128 threads", ((CAT_THREADS, CAT_THREADS.replace("256", "128")),), 128, 1),
    ("512 threads", ((CAT_THREADS, CAT_THREADS.replace("256", "512")),), 512, 1),
    ("2 units", cat_units(2), 256, 2),
    ("4 units", cat_units(4), 256, 4),
)

PLAN_CHECK = "if (differs(p, q) ||"
RING = """    if (more) load_tile<I, VL>(x, ring + (s ^ 1) * units, a, ni, nj);
    cp_async_commit();
    cp_async_wait_prior();  // this tile's loads have landed
"""
ONE_STAGE = """    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
"""
RING_END = "    __syncthreads();  // the stage is read before the loads after next overwrite it\n"
ONE_STAGE_END = ("    __syncthreads();\n"
                 "    if (more) load_tile<I, VL>(x, ring + (s ^ 1) * units, a, ni, nj);\n")

TMA = r"""
#include <cuda.h>
#include <cudaTypedefs.h>

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c, int r,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c), "r"(r), "r"(smem_addr(bar)) : "memory");
}

// Tiles of tr x 32 (the 128-byte swizzle's span: unit b of row r sits at b ^ (r & 7)); a
// quarter warp reads 2 row groups x 4 units, 8 bank groups.  rows % 4 == 0: float4 stores.
__global__ void __launch_bounds__(256)
transpose_tma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out,
                     Tr<int> a) {
  extern __shared__ unsigned char tma_smem[];
  __shared__ uint64_t bar[2];
  float4* ring = reinterpret_cast<float4*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const int tr = 1 << a.tr_log2, units = tr * 8, pairs_log2 = a.tr_log2 - 3;
  const unsigned bytes = tr * 32 * 4, tiles_c = a.tiles_c, tiles = a.tiles;
  unsigned t = blockIdx.x, ti = t / tiles_c, tj = t - ti * tiles_c;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar[0], bytes);
    tma_load(ring, &map, tj * 32, ti * tr, &bar[0]);
  }
  const int id = threadIdx.x;
  const int a4 = (((id >> 3) & ((1 << pairs_log2) - 1)) << 1) | (id & 1);
  const int b = ((id >> (3 + pairs_log2)) << 2) | ((id >> 1) & 3);
  unsigned parity = 0;
  for (int s = 0;; s ^= 1) {
    t += gridDim.x;
    unsigned ni = ti + a.q, nj = tj + a.rem;
    if (nj >= tiles_c) {
      nj -= tiles_c;
      ++ni;
    }
    const bool more = t < tiles;
    if (more && threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(&bar[s ^ 1], bytes);
      tma_load(ring + (s ^ 1) * units, &map, nj * 32, ni * tr, &bar[s ^ 1]);
    }
    mbar_wait(&bar[s], (parity >> s) & 1);
    parity ^= 1u << s;
    const float4* st = ring + s * units;
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * a4 + i;
      const float4 q = st[row * 8 + (b ^ (row & 7))];
      v[i][0] = q.x;
      v[i][1] = q.y;
      v[i][2] = q.z;
      v[i][3] = q.w;
    }
    const unsigned rows = a.rows, r = ti * tr + 4 * a4, c = tj * 32 + 4 * b;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < (unsigned)a.cols && r < rows) {
        *reinterpret_cast<float4*>(out + ((c + e) * rows + r)) =
            make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
      }
    }
    if (!more) break;
    __syncthreads();
    ti = ni;
    tj = nj;
  }
}

}  // namespace

extern "C" int dfd_transpose_tma(const float* x, float* out, long long rows, long long cols,
                                 int tr, int grid, void* stream) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorInvalidValue;
  }
  if (rows % 4 || cols % 4 || reinterpret_cast<uintptr_t>(x) % 16 || rows * cols > kLimit32)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)tr}, unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const long long tiles_c = cdiv(cols, 32), tiles = cdiv(rows, tr) * tiles_c;
  int tr_log2 = 0;
  while ((1 << tr_log2) < tr) ++tr_log2;
  const Tr<int> a = {(int)rows, (int)cols, (int)tiles_c, (int)tiles, (int)(grid / tiles_c),
                     (int)(grid % tiles_c), tr_log2, 3, 0};
  transpose_tma_kernel<<<grid, 2 * tr, 2 * tr * 128 + 1024, (cudaStream_t)stream>>>(map, out,
                                                                                     a);
  return (int)cudaGetLastError();
}
"""


def build_variants(kernels) -> dict:
    """The copies of relayout.cu that ``kernels`` time, compiled together."""
    src = (ROOT / "dfd_tpu_torch" / "ops" / "csrc" / "relayout.cu").read_text()
    for part in (PLAN_CHECK, RING, RING_END, CAT_THREADS, CAT_BODY, CAT_GRID) + PUTS:
        if part not in src:
            raise RuntimeError(f"relayout.cu no longer holds {part!r}")
    sources = {}
    if "transpose" in kernels:
        anyplan = src.replace(PLAN_CHECK, "if (false ||")
        sources["anyplan"] = anyplan
        sources["one stage"] = anyplan.replace(RING, ONE_STAGE).replace(RING_END, ONE_STAGE_END)
        sources["tma"] = anyplan + TMA
    if "concat" in kernels:
        for name, swaps, _, _ in CAT_COPIES:
            text = src
            for old, new in swaps:
                text = text.replace(old, new)
            sources[name] = text
    out_dir = ROOT / "build" / "relayout_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / (re.sub(r"\W+", "_", name) + ".cu")
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        print(f"variants: built {name}; registers of its kernels: {', '.join(regs)}",
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].dfd_transpose.argtypes = [vp, vp, i64, i64] + [i32] * 6 + [vp]
        libs[name].dfd_concat_scaled.argtypes = [vp, vp, i64, vp] + [i32] * 4 + [vp]
    if "tma" in libs:
        libs["tma"].dfd_transpose_tma.argtypes = [vp, vp, i64, i64, i32, i32, vp]
    return libs


def timed_rounds(fns: dict, rounds: int, dev) -> dict:
    """Each function's ``time_ms`` (20 calls) in ``rounds`` rounds, forward
    and backward in turn."""
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in list(fns)[:: 1 if r % 2 == 0 else -1]:
            times[k].append(time_ms(fns[k], dev, 20))
    return times


def concat_variants(libs: dict, card: str, dev) -> list:
    """The concat's copies at CONCATS (see the head of this file)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []
    for name, shape, k, ragged, rounds in CONCATS:
        x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(dev)
        v = x.view(-1)[1:] if ragged else x
        n = v.numel()
        scales = tuple(float(i) for i in range(1, k + 1))
        host = (ctypes.c_float * k)(*scales)
        s = torch.tensor(scales, dtype=torch.float32, device=dev)
        want = rl.concat_scaled_plain(v, scales)
        out = torch.empty_like(want)
        p = rl.concat_plan(v.data_ptr(), n, k)
        bound_ms = 4.0 * n * (1 + k) / BYTES_RATE * 1e3
        fns = {f"wrapper ({rl.CAT_THREADS} threads, a unit a thread, grid {p.grid})":
               lambda: rl.concat_scaled(v, scales)}
        for copy, _, threads, units in CAT_COPIES:
            q = p._replace(grid=-(-(n // p.width) // (threads * units)))

            def call(copy=copy, q=q):
                build.raise_on(libs[copy].dfd_concat_scaled(v.data_ptr(), out.data_ptr(), n,
                                                            host, k, *q, stream()), copy)
                return out

            fns[f"{copy} (grid {q.grid})"] = call
        fns["torch.cat of k products"] = lambda: rl.concat_scaled_plain(v, scales)
        fns["one broadcasting multiply"] = lambda: concat_library(v, s)
        for key, f in fns.items():
            out.fill_(float("nan"))
            assert torch.equal(f(), want), (name, key)
        del want
        times = timed_rounds(fns, rounds, dev)
        print(f"variants: concat {name}, {p.route}, bytes bound {bound_ms:.4f} ms ({card}):",
              flush=True)
        for key, t in times.items():
            mean = sum(t) / len(t)
            rows.append({"case": f"concat {name} {key}", "mean_ms": mean, "min_ms": min(t),
                         "max_ms": max(t), "share_of_bound": bound_ms / mean, "rounds_ms": t})
            print(f"variants:   {key:>52}: mean {mean:.5f} ms ({bound_ms / mean:.3f} of the "
                  f"bound), rounds {min(t):.5f}-{max(t):.5f}", flush=True)
        del out, x, v
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=("transpose", "concat"),
                    default=["transpose", "concat"])
    ap.add_argument("--out", default=str(ROOT / "build" / "relayout_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_relayout_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_variants(args.kernels)
    dev = torch.device("cuda")
    rows = concat_variants(libs, card, dev) if "concat" in args.kernels else []
    if "transpose" in args.kernels:
        rows += transpose_variants(libs, card, dev)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


def transpose_variants(libs: dict, card: str, dev) -> list:
    """The transpose's tiles, grids and variants (see the head of this file)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    x = torch.from_numpy(np.random.RandomState(0).randn(*SHAPE).astype(np.float32)).to(dev)
    bound_ms = 2 * 4.0 * x.numel() / BYTES_RATE * 1e3
    rows = []
    for R, C in TRANSPOSES:
        v = x.view(R, C)
        want = v.t().contiguous()
        out = torch.empty_like(want)
        p = rl.transpose_plan(v.data_ptr(), R, C)

        def call(lib, plan):
            build.raise_on(libs[lib].dfd_transpose(v.data_ptr(), out.data_ptr(), R, C, *plan,
                                                   stream()), lib)
            return out

        tma_tr = 128 if R >= 128 else max(16, 1 << (R - 1).bit_length())
        tma_grid = min(-(-R // tma_tr) * -(-C // 32), rl.MAX_BLOCKS)

        def tma():
            build.raise_on(libs["tma"].dfd_transpose_tma(v.data_ptr(), out.data_ptr(), R, C,
                                                         tma_tr, tma_grid, stream()), "tma")
            return out

        fns = {f"wrapper {p.tr}x{p.tc} grid {p.grid}": lambda: rl.transpose(v),
               f"one stage {p.tr}x{p.tc} grid {p.grid}": lambda: call("one stage", p),
               f"tma {tma_tr}x32 grid {tma_grid}": tma}
        for tr, tc in TILES:
            tiles = -(-R // tr) * -(-C // tc)
            for grid in GRIDS:
                if grid <= tiles:
                    plan = p._replace(tr=tr, tc=tc, grid=grid)
                    fns[f"anyplan {tr}x{tc} grid {grid}"] = lambda plan=plan: call("anyplan",
                                                                                   plan)
        fns["clone of x (a flat copy)"] = lambda: x.clone()
        for name, f in fns.items():
            if not name.startswith("clone"):
                out.fill_(float("nan"))
                assert torch.equal(f(), want), (R, C, name)
        del want
        times = timed_rounds(fns, 4, dev)
        print(f"variants: transpose x.view({R}, {C}), bytes bound {bound_ms:.4f} ms "
              f"({card}):", flush=True)
        for k, t in times.items():
            mean = sum(t) / len(t)
            rows.append({"case": f"transpose [{R}, {C}] {k}", "mean_ms": mean, "min_ms": min(t),
                         "max_ms": max(t), "share_of_bound": bound_ms / mean, "rounds_ms": t})
            print(f"variants:   {k:>28}: mean {mean:.4f} ms ({bound_ms / mean:.3f} of the "
                  f"bound), rounds {min(t):.4f}-{max(t):.4f}", flush=True)
        del out
        torch.cuda.empty_cache()
    del x
    for seed, (R, C) in enumerate(((16, 4096), (48, 1024))):
        v = torch.from_numpy(np.random.RandomState(seed).randn(R, C).astype(np.float32)).to(dev)
        want = v.t().contiguous()
        out = torch.empty_like(want)
        p = rl.transpose_plan(v.data_ptr(), R, C)
        fns = {f"wrapper {p.tr}x{p.tc} grid {p.grid}": lambda: rl.transpose(v)}
        for tr, tc in PROBE_TILES:
            tiles = -(-R // tr) * -(-C // tc)
            plan = p._replace(tr=tr, tc=tc, grid=tiles)

            def run(plan=plan):
                build.raise_on(libs["anyplan"].dfd_transpose(v.data_ptr(), out.data_ptr(), R, C,
                                                             *plan, stream()), "anyplan")
                return out

            fns[f"anyplan {tr}x{tc} grid {tiles}"] = run
        fns["t().contiguous()"] = lambda: v.t().contiguous()
        for f in fns.values():
            out.fill_(float("nan"))
            assert torch.equal(f(), want), (R, C)
        times = timed_rounds(fns, 8, dev)
        print(f"variants: probe transpose [{R}, {C}] ({card}):", flush=True)
        for k, t in times.items():
            mean = sum(t) / len(t)
            rows.append({"case": f"probe transpose [{R}, {C}] {k}", "mean_ms": mean,
                         "min_ms": min(t), "max_ms": max(t), "rounds_ms": t})
            print(f"variants:   {k:>28}: mean {mean:.5f} ms, rounds {min(t):.5f}-{max(t):.5f}",
                  flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
