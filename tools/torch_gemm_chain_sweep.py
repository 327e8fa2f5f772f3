"""Time every launch plan of the gemm_chain kernel at the probes' shapes, and mma.sync alone.

    python3 tools/torch_gemm_chain_sweep.py [--iters 32] [--out FILE]

Three measurements on the card, for choosing and checking ``gemm_chain_plan``'s
model and its ordered route (``dfd_tpu_torch/ops/gemm_chain.py``):

1. mma.sync.m16n8k8 TF32 alone: a kernel of register-only chains, one warp
   and then every SM, with 1, 4 and 8 independent accumulators a warp: its
   latency and its issue rate a warp scheduler.
2. The plan sweep: ``csrc/gemm_chain.cu`` built once more with its entry's
   plan check taken out, then, for each shape of the gemm, torso and pool
   probes, every plan (block shape, K split, cluster) whose panels fit, held
   to the plain version and timed (``time_ms``, ``--iters`` products a
   launch, so the launch's fixed cost is spread over them).  Each shape's
   line gives the model's plan and its time beside the fastest plans.
3. Why the gemm probe's 1024-product chain takes the ordered route: how far
   the plain version's float32 chain, the 3xTF32 chain and the ordered
   route lie from the exact chain (float64) and from each other, and how far
   one product of each lies from the exact product in ulps.

The mma kernel and the copy of the source are built with ``nvcc`` into
``build/gemm_chain_sweep/``.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
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
from dfd_tpu_torch.ops import gemm_chain as gc  # noqa: E402
from dfd_tpu_torch.probes import gemm as pgemm  # noqa: E402
from dfd_tpu_torch.probes import torso as ptorso  # noqa: E402
from dfd_tpu_torch.utils.profiling import time_ms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "gemm_chain_sweep"
SHAPES = sorted({c[:3] for c in pgemm.CASES} | {s[1:] for s in ptorso.GEMM_SHAPES}
                | {(16, 4096, 1024)})

MMA_BENCH = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int ILP>
__global__ void chains(float* out, int rounds) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (3u * (threadIdx.x + i)) & 0x3f800000u;
  for (int i = 0; i < 2; ++i) b[i] = (3u * (threadIdx.x + 7 * i)) & 0x3f800000u;
  float c[ILP][4] = {};
  for (int r = 0; r < rounds; ++r)
#pragma unroll
    for (int i = 0; i < ILP; ++i) mma(c[i], a, b);
  float s = 0;
  for (int i = 0; i < ILP; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int ILP>
void run(int blocks, int warps, float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int rounds = 4096;
  chains<ILP><<<blocks, 32 * warps>>>(out, 16);
  cudaEventRecord(e0);
  chains<ILP><<<blocks, 32 * warps>>>(out, rounds);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  int clock_khz;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  const double mmas = (double)blocks * warps * rounds * ILP;
  printf("mma.sync m16n8k8 tf32: %d blocks of %d warps, %d chains a warp: %.4f ms, "
         "%.1f TFLOP/s, %.2f cycles an mma a warp at %d MHz\n", blocks, warps, ILP, ms,
         mmas * 2048 / ms / 1e9, ms * 1e-3 * clock_khz * 1e3 / (rounds * ILP), clock_khz / 1000);
}
int main() {
  float* out;
  cudaMalloc(&out, 132 * 1024 * sizeof(float));
  run<1>(1, 1, out); run<4>(1, 1, out); run<8>(1, 1, out);
  run<1>(132, 4, out); run<4>(132, 4, out); run<4>(132, 8, out); run<8>(132, 16, out);
  return 0;
}
"""


def nvcc(args) -> None:
    done = subprocess.run([build.nvcc_path(), *args], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")


def any_plan_library() -> ctypes.CDLL:
    """gemm_chain.cu with the entry's plan check replaced by the given plan."""
    src = (build.CSRC / "gemm_chain.cu").read_text()
    check = re.search(r"  if \(!plan_gemm\(.*?return \(int\)cudaErrorInvalidValue;", src, re.S)
    src = src.replace(check[0], """  p.wm = wm; p.wn = wn; p.wk = wk; p.mt = mt; p.nt = nt; p.cluster = cluster; p.ks = ks;
  p.blocks = (int)(cdiv(M, 16 * wm * mt) * cdiv(N, 8 * wn * nt) * cluster);
  p.smem = (int)plan_smem(16 * wm * mt, 8 * wn * nt, ks, wk, cluster);""")
    (OUT_DIR / "gemm_chain_any_plan.cu").write_text(src)
    lib = OUT_DIR / "libgemm_chain_any_plan.so"
    nvcc([*build.NVCC_FLAGS, "-o", str(lib), str(OUT_DIR / "gemm_chain_any_plan.cu")])
    so = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.dfd_gemm_chain.argtypes = [vp] * 4 + [i32] * 5 + [ctypes.c_float] + [i32] * 8 + [vp]
    return so


def sweep(lib: ctypes.CDLL, iters: int) -> dict:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for M, K, N in SHAPES:
        g = torch.Generator(dev).manual_seed(0)
        a = 0.1 * torch.randn(M, K, device=dev, generator=g)
        b = 0.1 * torch.randn(K, N, device=dev, generator=g)
        out, carry = torch.empty(M, N, device=dev), torch.empty(2, device=dev)
        want = gc.gemm_chain_plain(a, b, iters, "acc")
        scale = max(1.0, want.abs().max().item())
        rows = []
        for (wm, wn, mt, nt), cluster, wk in itertools.product(gc.WARP_TILES, gc.CLUSTERS,
                                                               gc.WARP_K):
            ks = (-(-K // cluster) + 7) // 8 * 8
            if wm * wn * wk > 8 or (wk > 1 and wk > ks // 8):
                continue
            if gc._plan_smem(16 * wm * mt, 8 * wn * nt, ks, wk, cluster) > gc.SMEM_MAX:
                continue
            call = lambda: build.raise_on(lib.dfd_gemm_chain(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, iters, 0,
                1.0, wm, wn, wk, mt, nt, cluster, ks, 0,
                torch.cuda.current_stream().cuda_stream), "gemm_chain")
            call()
            err = (out - want).abs().max().item() / scale
            if not err <= 1e-5:
                raise AssertionError(f"[{M}x{K}]x[{K}x{N}] plan {(wm, wn, wk, mt, nt, cluster)}: "
                                     f"{err} of the scale")
            rows.append({"plan": (wm, wn, wk, mt, nt, cluster),
                         "us_per_iter": time_ms(call, dev, 5) / iters * 1e3, "err": err})
        rows.sort(key=lambda r: r["us_per_iter"])
        p = gc.gemm_chain_plan(M, K, N)
        mine = next(r for r in rows if r["plan"] == (p.wm, p.wn, p.wk, p.mt, p.nt, p.cluster))
        print(f"sweep [{M}x{K}]x[{K}x{N}]: {len(rows)} plans; the model's (wm, wn, wk, mt, nt, "
              f"cluster) {mine['plan']} {mine['us_per_iter']:.3f} us an iteration, "
              f"{mine['us_per_iter'] / rows[0]['us_per_iter']:.3f}x the fastest; fastest "
              + ", ".join(f"{r['plan']} {r['us_per_iter']:.3f}" for r in rows[:4]), flush=True)
        res[f"{M}x{K}x{N}"] = rows
    return res


def chain_distances(lib: ctypes.CDLL) -> dict:
    """The gemm probe's 1024 x 144 x 16 chain of 1024 products on its own
    inputs (``RandomState(0)``, times 0.01), by the plain version, the
    tensor-core route (its plan, forced past the ordered route) and the
    wrapper (the ordered route)."""
    dev = torch.device("cuda")
    M, K, N, iters = 1024, 144, 16, 1024
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 0.01).to(dev)
    b = torch.from_numpy(rng.randn(K, N).astype(np.float32) * 0.01).to(dev)
    p = gc.gemm_chain_plan(M, K, N)

    def tensor(n: int) -> torch.Tensor:
        out, carry = torch.empty(M, N, device=dev), torch.empty(2, device=dev)
        build.raise_on(lib.dfd_gemm_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, n, 0, 1.0,
            p.wm, p.wn, p.wk, p.mt, p.nt, p.cluster, p.ks, 0,
            torch.cuda.current_stream().cuda_stream), "gemm_chain")
        return out

    exact_y = a.double() @ b.double()
    exact = exact_y * iters
    chains = {"plain": gc.gemm_chain_plain(a, b, iters, "acc"), "3xTF32": tensor(iters),
              "ordered": gc.gemm_chain(a, b, iters, "acc")}
    scale = max(1.0, chains["plain"].abs().max().item())
    res = {"scale": scale, "limit": 1e-5 * scale}
    for name, c in chains.items():
        res[f"{name} - exact"] = (c.double() - exact).abs().max().item()
        res[f"{name} - plain"] = (c - chains["plain"]).abs().max().item()
    y_mm = a @ b
    ulp = (torch.nextafter(y_mm.abs(), torch.tensor(float("inf"), device=dev)) - y_mm.abs())
    for name, y in (("torch.mm", y_mm), ("3xTF32", tensor(1))):
        res[f"{name} product, mean ulps from exact"] = \
            ((y.double() - exact_y).abs() / ulp.double()).mean().item()
    print("ordered route: 1024 x 144 x 16, 1024 products: " + ", ".join(
        f"{k} {v:.3g}" for k, v in res.items()), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--out", default=str(ROOT / "build" / "gemm_chain_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gemm_chain_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "mma_bench.cu").write_text(MMA_BENCH)
    nvcc(["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(OUT_DIR / "mma_bench"),
          str(OUT_DIR / "mma_bench.cu")])
    print(subprocess.run([str(OUT_DIR / "mma_bench")], capture_output=True, text=True,
                         check=True).stdout, end="", flush=True)
    lib = any_plan_library()
    res = sweep(lib, args.iters)
    distances = chain_distances(lib)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "iters": args.iters, "shapes": res, "ordered": distances}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
