"""Time the port's perturb and gemm_chain kernels against another checkout's, in turns, on one card.

    python3 tools/torch_kernel_turns.py --parent DIR [--out FILE]

DIR is the root of another checkout of this repository (an earlier commit,
unpacked with ``git archive``).  Its ``dfd_tpu_torch/ops/csrc/perturb.cu``
and ``gemm_chain.cu`` are built with the same ``nvcc`` flags as this
checkout's (``dfd_tpu_torch/ops/build.py``) into ``build/kernel_turns/``
and called through their own C entry points; this checkout's kernels go
through their wrappers.  Each case is timed parent, change, change, parent
(``time_ms``, CUDA events), so the two versions share the card, its clocks
and its power limit: perturb at the trained cells' shapes, and gemm_chain at
the gemm probe's ten cases, the torso probe's seven chains and the pool
probe's Sel-GEMM.  Each output is checked against the plain version first.
Prints one line a case and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dfd_tpu_torch.ops import build  # noqa: E402
from dfd_tpu_torch.ops import gemm_chain as gc  # noqa: E402
from dfd_tpu_torch.ops import perturb as pk  # noqa: E402
from dfd_tpu_torch.probes import gemm as pgemm  # noqa: E402
from dfd_tpu_torch.probes.pool import even_positions  # noqa: E402
from dfd_tpu_torch.probes import torso as ptorso  # noqa: E402
from dfd_tpu_torch.utils.profiling import time_ms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PERTURB_SHAPES = ((2048, 5197), (128, 1_156_139), (64, 7_872_651))


def build_parent(parent: Path) -> dict:
    """The parent's two libraries, compiled together."""
    out_dir = ROOT / "build" / "kernel_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("perturb", "gemm_chain"):
        lib = out_dir / f"lib{name}_parent.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(parent / "dfd_tpu_torch" / "ops" / "csrc" / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    libs["perturb"].dfd_perturb.argtypes = [vp, vp, i32, i32, ctypes.c_float, u32, u32, i32, vp]
    libs["gemm_chain"].dfd_gemm_chain.argtypes = [vp] * 4 + [i32] * 5 + [ctypes.c_float, vp]
    return libs


def turns(name: str, parent, change, iters: int) -> dict:
    """parent, change, change, parent; the mean of each version's two."""
    t = [time_ms(f, torch.device("cuda"), iters) for f in (parent, change, change, parent)]
    row = {"case": name, "parent_ms": (t[0] + t[3]) / 2, "change_ms": (t[1] + t[2]) / 2,
           "turns_ms": t}
    row["speedup"] = row["parent_ms"] / row["change_ms"]
    print(f"turns: {name}: parent {row['parent_ms']:.4f} ms, change {row['change_ms']:.4f} ms "
          f"({row['speedup']:.2f}x; turns {', '.join(f'{x:.4f}' for x in t)})", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_turns.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_parent(args.parent)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []

    for P, d in PERTURB_SHAPES:
        theta = torch.randn(d, device=dev)
        out = torch.empty(P, d, device=dev)

        def parent():
            build.raise_on(libs["perturb"].dfd_perturb(theta.data_ptr(), out.data_ptr(), P, d,
                                                       0.05, 0, 7, 0, stream()), "parent perturb")
            return out

        want = pk.perturb_plain(theta, 0.05, 0, 7, P)
        for f in (parent, lambda: pk.perturb(theta, 0.05, 0, 7, P)):
            assert (f() - want).abs().max().item() <= 1e-6
        del want
        rows.append(turns(f"perturb P={P} d={d}", parent, lambda: pk.perturb(theta, 0.05, 0, 7, P),
                          20))
        del out

    sel = np.zeros((4096, 1024), np.float32)
    sel[even_positions(64, 64), np.arange(1024)] = 1.0
    chains = [(f"gemm [{mode}] [{M}x{K}]x[{K}x{N}] iters={iters}", M, K, N, iters, mode, 0.01)
              for M, K, N, iters, mode in pgemm.CASES]
    chains += [(f"torso {name} iters={ptorso.ITERS}", M, K, N, ptorso.ITERS, "acc_scaled", 1.0)
               for name, M, K, N in ptorso.GEMM_SHAPES]
    chains.append(("pool D Sel-GEMM [16,4096]x[4096,1024]", 16, 4096, 1024, 1, "acc", None))
    for name, M, K, N, iters, mode, scale in chains:
        rng = np.random.RandomState(0)
        if scale is None:
            a = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev)
            b = torch.from_numpy(sel).to(dev)
        else:
            a = torch.from_numpy(rng.randn(M, K).astype(np.float32) * scale).to(dev)
            b = torch.from_numpy(rng.randn(K, N).astype(np.float32) * scale).to(dev)
        out = torch.empty(M, N, device=dev)
        carry = torch.empty(2, device=dev)

        def parent():
            build.raise_on(libs["gemm_chain"].dfd_gemm_chain(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, iters,
                gc.MODES.index(mode), gc._inv(iters), stream()), "parent gemm_chain")
            return out

        change = lambda: gc.gemm_chain(a, b, iters, mode)
        want = gc.gemm_chain_plain(a, b, iters, mode)
        tol = 1e-5 * max(1.0, want.abs().max().item())
        for f in (parent, change):
            assert (f() - want).abs().max().item() <= tol, name
        rows.append(turns(name, parent, change, 5))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
