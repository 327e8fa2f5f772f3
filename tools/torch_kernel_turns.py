"""Time the port's kernels against another checkout's, in turns, on one card.

    python3 tools/torch_kernel_turns.py --parent DIR [--kernels K ...] [--out FILE]

DIR is the root of another checkout of this repository (an earlier commit,
unpacked with ``git archive``) whose C entry points have the interfaces of
commit 67921d8: ``dfd_combine``, ``dfd_res_chain``, ``dfd_gemm_chain``,
``dfd_roll``, ``dfd_strided_copy``, ``dfd_gather_cols`` and
``dfd_transpose`` with their plans, ``dfd_concat_scaled(x, out, n, scales,
n_scales, stream)`` without one; for ``swimmer``, a ``dfd_swimmer_step`` that
takes this checkout's ``SwimmerArgs``; for ``torso_tiled``, commit b0f6bc3's
``dfd_res_stage_tiled_tf32`` and ``dfd_feat_pool_tiled_tf32`` (a weight image
and a split flag) and ``dfd_res_stage_tiled_mma`` and
``dfd_feat_pool_tiled_mma`` (no weight image), whose plans the tool takes
from that checkout's own ``dfd_tpu_torch/ops/fused_resblock.py``.
Its ``dfd_tpu_torch/ops/csrc/perturb.cu``, ``gemm_chain.cu``,
``res_chain.cu``, ``relayout.cu``, ``swimmer.cu``, ``fused_resblock_tf32.cu``
and ``fused_resblock_mma.cu`` are built with the same ``nvcc`` flags
as this checkout's (``dfd_tpu_torch/ops/build.py``) into
``build/kernel_turns/`` and called through their own C entry points; this
checkout's kernels go through their wrappers.  ``--kernels`` picks the
groups to time (``perturb``: perturb, combine and combine's plan sweep;
``gemm_chain``; ``res_chain``; ``relayout``; ``swimmer``; ``torso_tiled``:
the tiled res stage and feature pool of ``fused_resblock_tf32.cu`` at
``impala_128px``'s three shapes, M = 16, and of ``fused_resblock_mma.cu``
(bf16) at 192-pixel frames' three, res 64 @ 96x96 and res 128 @ 48x48 at
M = 16, the pool 64 -> 128 @ 192x192 at M = 2, five rounds each, with
cuDNN's chain (f32 or bf16 tensors) in the same turns, then once more with
both versions' weight image made every call, as on a rollout's first step
(the bf16 parent has none), all by default; only their
libraries are built.  Each case is timed parent,
change, change, parent (``time_ms``, CUDA events), so the two versions share
the card, its clocks and its power limit: perturb and combine at the trained
cells' shapes (combine also antithetic at ``mlp_trap``'s), gemm_chain at the
gemm probe's ten cases, the torso probe's seven chains and the pool probe's
Sel-GEMM, res_chain at the wide probe's twelve chains and the pool
probe's three, and the relayouts with their PyTorch call (``torch.roll``,
``clone``, ``index_select``, ``t().contiguous()``; for the concat one
broadcasting multiply, ``probes/torso.py::concat_library``) in the same
turns: parent, change, PyTorch, PyTorch, change, parent.  The relayouts run
at the torso and pool probes' cases and where bytes decide: roll and strided_copy
at ``impala_prod_bf16``'s stage-0 novelty activation seen as ``x [33280,
1024]`` (rolls by 1 and 32 along lanes and by 1 along rows; ``x[::2, :]``,
``x[:, ::2]``, ``x3[:, ::2, :]`` and the reshape copy of ``x3 =
x.view(33280, 32, 32)``), the transpose of ``x`` seen as ``[33280, 1024]``,
``[64, 532480]``, ``[532480, 64]``, ``[16, 2129920]`` and ``[2129920, 16]``
(where the parent refuses a case, that is printed and its turns are change,
PyTorch, PyTorch, change), and the gather of the pool's even positions from
``x_pool [33280, 4096]`` and of a permutation of ``x``'s columns, and the
concat of ``x`` by 3 and by 8 scales and of ``x.view(-1)[1:]`` by 3 (the
probe's concat, of its ``x [128, 1024]`` by 3, among the probe cases).  Combine
and the relayouts take five such rounds, and their spread (the fastest and
slowest round's ratio) is printed.  Each output is checked against the
plain version first (the relayouts bit for bit).  The swimmer's step runs
at 513 episodes (``gaussian_swimmer``'s launch) from random states and
actions and at the host topology's one episode (the first of them), at 7
links (the template form) and at 12, 15, 32 and 64 (the run-time form), five
rounds each, after a check of whether the two versions' outputs are equal
bit for bit and of their largest absolute difference.

Then combine's plans at ``impala_procmaze``'s and ``impala_prod_bf16``'s
shapes: this checkout's ``perturb.cu`` is built once more with the entry's
refusal of another plan taken out of its text, and every plan of one
cluster rank (``lt`` from 256 down to 16 threads a row, ``mg = 256 / lt``
groups) is timed in four rounds, in turn with the parent and the wrapper
(the plan ``combine_plan`` picks); each round runs them forward or
backward.  Prints one line a case and writes them as JSON to ``--out``.
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

from dfd_tpu_torch.envs import SwimmerEnv  # noqa: E402
from dfd_tpu_torch.ops import build  # noqa: E402
from dfd_tpu_torch.ops import gemm_chain as gc  # noqa: E402
from dfd_tpu_torch.ops import perturb as pk  # noqa: E402
from dfd_tpu_torch.ops import relayout as rl  # noqa: E402
from dfd_tpu_torch.ops import res_chain as rc  # noqa: E402
from dfd_tpu_torch.ops import swimmer as sw  # noqa: E402
from dfd_tpu_torch.probes import gemm as pgemm  # noqa: E402
from dfd_tpu_torch.probes import pool as ppool  # noqa: E402
from dfd_tpu_torch.probes import torso as ptorso  # noqa: E402
from dfd_tpu_torch.probes import wide as pwide  # noqa: E402
from dfd_tpu_torch.probes.pool import even_positions  # noqa: E402
from dfd_tpu_torch.utils.profiling import time_ms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PERTURB_SHAPES = ((2048, 5197), (128, 1_156_139), (64, 7_872_651))
# the production transposes of x [33280, 1024], as x.view(rows, cols) (chip_smoke.py's)
TRANSPOSES = ((33280, 1024), (64, 532480), (532480, 64), (16, 2129920), (2129920, 16))
GROUPS = ("perturb", "gemm_chain", "res_chain", "relayout", "swimmer", "torso_tiled")
# a library's source where it is not its name
SOURCE = {"torso_tiled": "fused_resblock_tf32", "torso_tiled_mma": "fused_resblock_mma"}
SWIMMER_LINKS = (7, 12, 15, 32, 64)  # the template form of gaussian_swimmer, then the run-time form
# (kind, bf16, members, ci, co, H, W): impala_128px's three tiled f32 calls (chip_smoke.py's
# BIG_CHUNK members, one frame each), then 192-pixel frames' three bf16 ones (PERF.md rows 3d
# and 4d)
TORSO_TILED = (("res", False, 16, 64, 64, 64, 64), ("feat", False, 16, 64, 128, 64, 64),
               ("res", False, 16, 128, 128, 32, 32), ("res", True, 16, 64, 64, 96, 96),
               ("res", True, 16, 128, 128, 48, 48), ("feat", True, 2, 64, 128, 192, 192))


# dfd_combine's refusal of any plan but combine_plan's, and what the sweep builds instead
PLAN_CHECK = "p.lt != lt || p.mg != mg || p.cl != cl"
PLAN_SWEEP_SHAPES = ((128, 1_156_139), (64, 7_872_651))


def build_parent(parent: Path, groups) -> dict:
    """The parent's libraries of ``groups`` and, with perturb, this
    checkout's perturb taking any plan (``anyplan``), compiled together."""
    out_dir = ROOT / "build" / "kernel_turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [g for g in GROUPS if g in groups]
    if "perturb" in groups:
        src = (ROOT / "dfd_tpu_torch" / "ops" / "csrc" / "perturb.cu").read_text()
        if PLAN_CHECK not in src:
            raise RuntimeError("perturb.cu's dfd_combine no longer holds its plan check")
        anyplan = out_dir / "perturb_anyplan.cu"
        anyplan.write_text(src.replace(PLAN_CHECK, "false"))
        names.append("anyplan")
    if "torso_tiled" in groups:
        names.append("torso_tiled_mma")
    procs = {}
    for name in names:
        lib = out_dir / (f"lib{name}.so" if name == "anyplan" else f"lib{name}_parent.so")
        cu = (anyplan if name == "anyplan" else
              parent / "dfd_tpu_torch/ops/csrc" / f"{SOURCE.get(name, name)}.cu")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry in log.split("Compiling entry function")[1:]:  # the parent's tiled forms
            if name.startswith("torso_tiled") and "tiled" in entry.split("\n")[0]:
                regs = re.search(r"Used (\d+) registers", entry)
                spill = re.search(r"(\d+) bytes spill stores", entry)
                print(f"build: parent {entry.split()[0][:80]}: {regs[1] if regs else '?'} "
                      f"registers, {spill[1] if spill else '?'} bytes spill stores", flush=True)
    vp, i32, u32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    if "perturb" in libs:
        libs["perturb"].dfd_perturb.argtypes = [vp, vp, i32, i32, ctypes.c_float, u32, u32, i32,
                                                vp]
        libs["perturb"].dfd_combine.argtypes = [vp, vp, i32, i32, u32, u32] + [i32] * 4 + [vp]
        libs["anyplan"].dfd_combine.argtypes = [vp, vp, i32, i32, u32, u32] + [i32] * 4 + [vp]
    if "gemm_chain" in libs:
        libs["gemm_chain"].dfd_gemm_chain.argtypes = ([vp] * 4 + [i32] * 5 + [ctypes.c_float]
                                                      + [i32] * 8 + [vp])
    if "res_chain" in libs:
        libs["res_chain"].dfd_res_chain.argtypes = [vp] * 4 + [i32] * 15 + [vp]
    if "relayout" in libs:
        lib = libs["relayout"]
        lib.dfd_roll.argtypes = [vp, vp, i64, i64, i64, i32] + [i32] * 5 + [i64, i32, vp]
        lib.dfd_strided_copy.argtypes = [vp, vp] + [i64] * 6 + [i32] * 5 + [i64, i32, vp]
        lib.dfd_gather_cols.argtypes = [vp, vp, vp, i64, i64, i64] + [i32] * 4 + [i64, i32, vp]
        lib.dfd_transpose.argtypes = [vp, vp, i64, i64] + [i32] * 6 + [vp]
        lib.dfd_concat_scaled.argtypes = [vp, vp, i64, vp, i32, vp]
    if "swimmer" in libs:
        libs["swimmer"].dfd_swimmer_step.argtypes = [ctypes.POINTER(sw._Args), i32, vp]
    if "torso_tiled" in libs:
        libs["torso_tiled"].dfd_res_stage_tiled_tf32.argtypes = [vp] * 8 + [i32] * 8 + [vp]
        libs["torso_tiled"].dfd_feat_pool_tiled_tf32.argtypes = [vp] * 7 + [i32] * 9 + [vp]
        libs["torso_tiled_mma"].dfd_res_stage_tiled_mma.argtypes = [vp] * 7 + [i32] * 7 + [vp]
        libs["torso_tiled_mma"].dfd_feat_pool_tiled_mma.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    return libs


def parent_module(parent: Path, rel: str, name: str):
    """A module of the parent checkout, loaded from its file (its own
    imports resolve to this checkout's package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, parent / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def torso_tiled_turns(libs: dict, parent: Path, dev: torch.device) -> list:
    """The tiled torso forms at ``TORSO_TILED``'s shapes: the parent's C
    entries with the parent's own plans (from its ``ops/fused_resblock.py``;
    they refuse any other) and weight image (f32), this checkout's wrappers,
    and cuDNN's chain (``chip_smoke.py::_chain``, TF32 off; bf16 tensors for
    the bf16 forms) in the same turns, five rounds; each version checked
    against the plain version first.  Then both with the weight image made
    every call."""
    import chip_smoke
    from dfd_tpu_torch.ops import fused_resblock as fr

    pfr = parent_module(parent, "dfd_tpu_torch/ops/fused_resblock.py", "parent_fused_resblock")
    rows = []
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for kind, bf16, M, ci, co, H, W in TORSO_TILED:
        args, w_oihw = chip_smoke._fused_inputs(kind, M, 1, ci, co, H, W, dev, seed=7)
        cd = torch.bfloat16 if bf16 else None
        x = args[0]
        ptrs = [v.data_ptr() for v in args]
        lib = libs["torso_tiled_mma" if bf16 else "torso_tiled"]
        route = "mma" if bf16 else "tf32"
        if kind == "res":
            plan = getattr(pfr, f"res_stage_{route}_plan")(ci, H, W)
            out, scratch = torch.empty_like(x), torch.empty_like(x)
            wimg = None if bf16 else torch.empty(
                M * 4 * pfr.tf32_weight_image_floats(ci, ci, plan.group), device=dev)
            entry = getattr(lib, f"dfd_res_stage_tiled_{route}")
            image = [] if bf16 else [wimg.data_ptr()]  # wimg lives as long as the calls
            fixed = (*ptrs, *image, scratch.data_ptr(), out.data_ptr(), M, 1, ci, H, W)
            fn, plain = fr.fused_res_stage, fr.fused_res_stage_plain
        else:
            plan = getattr(pfr, f"feat_pool_{route}_plan")(ci, co, H, W)
            out = torch.empty(M, 1, co, (H + 1) // 2, (W + 1) // 2, device=dev)
            wimg = None if bf16 else torch.empty(
                M * pfr.tf32_weight_image_floats(ci, co, plan.group), device=dev)
            entry = getattr(lib, f"dfd_feat_pool_tiled_{route}")
            image = [] if bf16 else [wimg.data_ptr()]
            fixed = (*ptrs, *image, out.data_ptr(), M, 1, ci, co, H, W)
            fn, plain = fr.fused_feat_pool, fr.fused_feat_pool_plain

        def parent_call(split=0):
            flag = [] if bf16 else [split]
            build.raise_on(entry(*fixed, plan.rows, plan.cols, *flag, stream()),
                           f"parent tiled {kind} ({route})")
            return out

        change = lambda: fn(*args, compute_dtype=cd)
        want = plain(*args, compute_dtype=cd)
        tol = (chip_smoke.TOL_FUSED_RES_BF16 if bf16 and kind == "res" else
               chip_smoke.TOL_FUSED_F32) * max(1.0, want.abs().max().item())
        for f in (lambda: parent_call(1), change):
            assert (f() - want).abs().max().item() <= tol, (kind, route)
        del want
        chain_args = [x, w_oihw, *args[2:]]
        if bf16:
            chain_args = [v.to(torch.bfloat16) for v in chain_args]
        chain = lambda: chip_smoke._chain(kind, *chain_args)
        name = f"tiled {kind} {route} {ci}->{co} @{H}x{W} M={M}"
        rows.append(turns(name, parent_call, change, 20, rounds=5, library=chain))
        # the same with the weight image made every call (a rollout's first step)
        fresh = lambda: (fr._IMAGES.clear(), change())[1]
        rows.append(turns(name + ", weight image made every call", lambda: parent_call(1), fresh,
                          20, rounds=5))
    return rows


def turns(name: str, parent, change, iters: int, rounds: int = 1, library=None) -> dict:
    """``rounds`` times parent, change, change, parent (parent, change,
    library, library, change, parent with a ``library`` call); the mean and
    median of each version's times, and each round's ratio of parent to
    change."""
    if parent is None:  # the parent refuses the case: change and library alone
        order = (change, library, library, change)
    elif library is None:
        order = (parent, change, change, parent)
    else:
        order = (parent, change, library, library, change, parent)
    n = len(order)
    t = [time_ms(f, torch.device("cuda"), iters) for _ in range(rounds) for f in order]
    at = lambda f: [x for i, x in enumerate(t) if order[i % n] is f]
    mean = lambda xs: sum(xs) / len(xs)
    row = {"case": name, "change_ms": mean(at(change)), "change_median_ms":
           float(np.median(at(change))), "turns_ms": t}
    spread = ""
    if parent is not None:
        row["parent_ms"] = mean(at(parent))
        row["parent_median_ms"] = float(np.median(at(parent)))
        row["speedup"] = row["parent_ms"] / row["change_ms"]
        ratios = [sum(x for j, x in enumerate(t[i:i + n]) if order[j] is parent)
                  / sum(x for j, x in enumerate(t[i:i + n]) if order[j] is change)
                  for i in range(0, len(t), n)]
        row["speedup_min"], row["speedup_max"] = min(ratios), max(ratios)
        spread = f", rounds {min(ratios):.4f}-{max(ratios):.4f}x" if rounds > 1 else ""
    lib = ""
    if library is not None:
        row["library_ms"] = mean(at(library))
        lib = (f", PyTorch {row['library_ms']:.4f} ms (change "
               f"{row['change_ms'] / row['library_ms']:.4f}x of it)")
    versus = (f"parent {row['parent_ms']:.4f} ms, change {row['change_ms']:.4f} ms "
              f"({row['speedup']:.4f}x{spread})" if parent is not None else
              f"parent refuses, change {row['change_ms']:.4f} ms")
    print(f"turns: {name}: {versus}{lib}; turns {', '.join(f'{x:.4f}' for x in t)}", flush=True)
    return row


def relayout_cases(size: str, dev: torch.device) -> list:
    """(name, wrapper, arguments) of the relayouts at ``size``, "probe" or
    "production" (see the head of this file)."""
    R, L, split = (128, 1024, 64) if size == "probe" else (33280, 1024, 32)
    x = torch.from_numpy(np.random.RandomState(0).randn(R, L).astype(np.float32)).to(dev)
    x3 = x.view(R, L // split, split)
    cases = [(f"roll lanes shift={s}", rl.roll, (x, s, 1))
             for s in ((1, 64) if size == "probe" else (1, 32))]
    cases.append(("roll rows shift=1", rl.roll, (x, 1, 0)))
    cases += [(name, rl.strided_copy, (v,)) for name, v in (
        ("x[::2, :]", x[::2, :]), ("x[:, ::2]", x[:, ::2]), ("x3[:, ::2, :]", x3[:, ::2, :]),
        (f"reshape [{R},{L}]->{list(x3.shape)}", x3))]
    cases = [(f"{size} {name} of x [{R}, {L}]", fn, args) for name, fn, args in cases]
    scales = (1.0, 2.0, 3.0)
    cases.append((f"{size} concat k=3 of x [{R}, {L}]", rl.concat_scaled, (x, scales)))
    if size == "probe":
        xp = torch.from_numpy(np.random.RandomState(0).randn(16, 4096).astype(np.float32)).to(dev)
        xt = torch.from_numpy(np.random.RandomState(1).randn(48, 1024).astype(np.float32)).to(dev)
        even = torch.from_numpy(even_positions(64, 64)).to(dev)
        return cases + [("probe pool B x[:, ::2] of [16, 4096]", rl.strided_copy, (xp[:, ::2],)),
                        ("probe pool A gather even positions of [16, 4096]", rl.gather_cols,
                         (xp, even)),
                        ("probe pool C transpose [16, 4096]", rl.transpose, (xp,)),
                        ("probe pool C2 transpose [48, 1024]", rl.transpose, (xt,))]
    cases += [(f"production transpose x.view({r}, {c})", rl.transpose, (x.view(r, c),))
              for r, c in TRANSPOSES]
    x_pool = torch.randn(R, 4096, device=dev, generator=torch.Generator(dev).manual_seed(0))
    even = torch.from_numpy(even_positions(64, 64)).to(dev)
    perm = torch.from_numpy(np.random.RandomState(3).permutation(L).astype(np.int32)).to(dev)
    return cases + [(f"production gather even positions of x_pool [{R}, 4096]", rl.gather_cols,
                     (x_pool, even)),
                    ("production gather a permutation of x's columns", rl.gather_cols, (x, perm)),
                    (f"production concat k=8 of x [{R}, {L}]", rl.concat_scaled,
                     (x, tuple(float(i) for i in range(1, 9)))),
                    (f"production concat k=3 of x.view(-1)[1:] [{R * L - 1}]", rl.concat_scaled,
                     (x.view(-1)[1:], scales))]


def relayout_turns(libs: dict, dev: torch.device) -> list:
    """The relayouts against the parent's and their PyTorch call, at the
    probes' cases and where bytes decide."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    lib = libs["relayout"]
    plain = {rl.roll: rl.roll_plain, rl.strided_copy: rl.strided_copy_plain,
             rl.gather_cols: rl.gather_cols_plain, rl.transpose: rl.transpose_plain,
             rl.concat_scaled: rl.concat_scaled_plain}
    rows = []
    for size in ("probe", "production"):
        for name, fn, args in relayout_cases(size, dev):
            v = args[0]
            library = lambda fn=fn, args=args: plain[fn](*args)
            want = library()
            if fn is rl.concat_scaled:
                s = torch.tensor(args[1], dtype=torch.float32, device=dev)
                library = lambda v=v, s=s: ptorso.concat_library(v, s)
                assert torch.equal(library(), want), name
            out = torch.empty_like(want)
            if fn is rl.roll:
                p = rl.roll_plan(v.data_ptr(), *v.shape, args[1], args[2])
                call = lambda: lib.dfd_roll(v.data_ptr(), out.data_ptr(), *v.shape, args[1],
                                            args[2], *p.launch, stream())
            elif fn is rl.strided_copy:
                pad = 3 - v.ndim
                sizes, strides = (1,) * pad + tuple(v.shape), (0,) * pad + v.stride()
                p = rl.strided_copy_plan(v.data_ptr(), sizes, strides)
                call = lambda: lib.dfd_strided_copy(v.data_ptr(), out.data_ptr(), *sizes,
                                                    *strides, *p.launch, stream())
            elif fn is rl.transpose:
                t = rl.transpose_plan(v.data_ptr(), *v.shape)
                call = lambda: lib.dfd_transpose(v.data_ptr(), out.data_ptr(), *v.shape, *t,
                                                 stream())
            elif fn is rl.gather_cols:
                g = rl.gather_cols_plan(*v.shape, args[1].numel())
                call = lambda: lib.dfd_gather_cols(v.data_ptr(), args[1].data_ptr(),
                                                   out.data_ptr(), *v.shape, args[1].numel(),
                                                   *g, stream())
            else:
                host = (ctypes.c_float * len(args[1]))(*args[1])
                call = lambda: lib.dfd_concat_scaled(v.data_ptr(), out.data_ptr(), v.numel(),
                                                     host, len(args[1]), stream())

            def parent(call=call, out=out, name=name):
                build.raise_on(call(), f"parent {name}")
                return out

            change = lambda fn=fn, args=args: fn(*args)
            try:
                parent()
            except RuntimeError as e:
                print(f"turns: {name}: the parent refuses it ({e}); no parent turns", flush=True)
                parent = None
            for f in (parent, change):
                if f is not None:
                    assert torch.equal(f(), want), name
            del want
            rows.append(turns(name, parent, change, 20, rounds=5, library=library))
            del out
        torch.cuda.empty_cache()
    return rows


def combine_plan_sweep(libs: dict, dev: torch.device) -> list:
    """Every one-rank plan of combine at PLAN_SWEEP_SHAPES, in rounds with
    the parent and the wrapper's plan."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []
    for P, d in PLAN_SWEEP_SHAPES:
        coefs = torch.randn(P, device=dev)
        g = torch.empty(d, device=dev)
        fns = {"parent": lambda: (build.raise_on(libs["perturb"].dfd_combine(
            coefs.data_ptr(), g.data_ptr(), P, d, 0, 7, 0, *pk.combine_plan(P, d), stream()),
            "parent combine"), g)[1],
               "combine_plan": lambda: pk.combine(coefs, 0, 7, d)}
        for lt in (256, 128, 64, 32, 16):
            fns[f"({lt}, {256 // lt}, 1)"] = lambda lt=lt: (build.raise_on(
                libs["anyplan"].dfd_combine(coefs.data_ptr(), g.data_ptr(), P, d, 0, 7, 0, lt,
                                            256 // lt, 1, stream()), "anyplan combine"), g)[1]
        want = pk.combine_plain(coefs, 0, 7, d)
        for f in fns.values():
            assert ((f() - want).norm() / want.norm()).item() <= 1e-5
        del want
        times = {k: [] for k in fns}
        for r in range(4):
            for k in list(fns)[:: 1 if r % 2 == 0 else -1]:
                times[k].append(time_ms(fns[k], dev, 20))
        print(f"plans: combine P={P} d={d}, combine_plan {pk.combine_plan(P, d)}", flush=True)
        for k, t in times.items():
            rows.append({"case": f"combine plan P={P} d={d} {k}", "mean_ms": sum(t) / len(t),
                         "min_ms": min(t), "max_ms": max(t), "rounds_ms": t})
            print(f"plans:   {k:>14}: mean {sum(t) / len(t):.4f} ms, rounds {min(t):.4f}-"
                  f"{max(t):.4f}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--kernels", nargs="+", choices=GROUPS, default=list(GROUPS))
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_turns.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_parent(args.parent, args.kernels)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []

    if "perturb" in args.kernels:
        for P, d in PERTURB_SHAPES:
            theta = torch.randn(d, device=dev)
            out = torch.empty(P, d, device=dev)

            def parent():
                build.raise_on(libs["perturb"].dfd_perturb(theta.data_ptr(), out.data_ptr(), P,
                                                           d, 0.05, 0, 7, 0, stream()),
                               "parent perturb")
                return out

            want = pk.perturb_plain(theta, 0.05, 0, 7, P)
            for f in (parent, lambda: pk.perturb(theta, 0.05, 0, 7, P)):
                assert (f() - want).abs().max().item() <= 1e-6
            del want
            rows.append(turns(f"perturb P={P} d={d}", parent,
                              lambda: pk.perturb(theta, 0.05, 0, 7, P), 20))
            del out

        for P, d, anti in [(P, d, False) for P, d in PERTURB_SHAPES] + [(2048, 5197, True)]:
            coefs = torch.randn(P, device=dev)
            g = torch.empty(d, device=dev)

            def parent():
                build.raise_on(libs["perturb"].dfd_combine(
                    coefs.data_ptr(), g.data_ptr(), P, d, 0, 7, int(anti),
                    *pk.combine_plan(P, d, anti), stream()), "parent combine")
                return g

            change = lambda: pk.combine(coefs, 0, 7, d, antithetic=anti)
            want = pk.combine_plain(coefs, 0, 7, d, antithetic=anti)
            for f in (parent, change):
                assert ((f() - want).norm() / want.norm()).item() <= 1e-5
            del want
            rows.append(turns(f"combine P={P} d={d}" + (" antithetic" if anti else ""), parent,
                              change, 20, rounds=5))
        rows += combine_plan_sweep(libs, dev)

    if "gemm_chain" in args.kernels:
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

            ordered = gc.ordered_route(iters, mode)
            p = gc.gemm_chain_plan(M, K, N, ordered, resident=mode == "feed")

            def parent():
                build.raise_on(libs["gemm_chain"].dfd_gemm_chain(
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, iters,
                    gc.MODES.index(mode), gc._inv(iters), p.wm, p.wn, p.wk, p.mt, p.nt, p.cluster,
                    p.ks, int(ordered), stream()), "parent gemm_chain")
                return out

            change = lambda: gc.gemm_chain(a, b, iters, mode)
            want = gc.gemm_chain_plain(a, b, iters, mode)
            tol = 1e-5 * max(1.0, want.abs().max().item())
            for f in (parent, change):
                assert (f() - want).abs().max().item() <= tol, name
            rows.append(turns(name, parent, change, 5))

    if "res_chain" in args.kernels:
        # res_chain: the wide probe's chains and the pool probe's, on the probes' inputs
        chains = [("wide", C, H, W, layout, tag, cd) for C, H, W in pwide.STAGES
                  for layout in ("channel_major", "channel_minor") for tag, cd in pwide.DTYPES]
        chains += [("pool", 16, 32, 32, layout, tag, cd) for tag, layout, cd in ppool.CHAINS]
        for probe, C, H, W, layout, tag, cd in chains:
            P, S, minor = 64, H * W, layout == "channel_minor"
            rng = np.random.RandomState(2)
            xs = torch.from_numpy(rng.randn(P, C, S).astype(np.float32) * 0.1).to(dev)
            ws = torch.from_numpy(rng.randn(P, 4, C, C * 9).astype(np.float32)
                                  * (0.02 if probe == "wide" else 0.05)).to(dev)
            bs = torch.from_numpy(rng.randn(P, 4, C).astype(np.float32) * 0.01).to(dev)
            x = xs.transpose(1, 2).contiguous() if minor else xs
            w = ws.transpose(2, 3).contiguous() if minor else ws
            out = torch.empty_like(x)
            plan = rc.res_chain_plan(P, C, H, W, layout, cd is not None)

            def parent():
                build.raise_on(libs["res_chain"].dfd_res_chain(
                    x.data_ptr(), w.data_ptr(), bs.data_ptr(), out.data_ptr(), P, 4, C, H, W,
                    int(minor), int(cd is not None), *plan[:-1], stream()), "parent res_chain")
                return out

            change = lambda: rc.res_chain(x, w, bs, H, W, layout, cd)
            want = rc.res_chain_plain(x, w, bs, H, W, layout, cd)
            tol = (1e-5 if cd is None else 5e-4) * max(1.0, want.abs().max().item())
            for f in (parent, change):
                assert (f() - want).abs().max().item() <= tol
            del want
            rows.append(turns(f"res_chain {probe} {layout} {tag} {C}ch@{H}x{W} P={P}", parent,
                              change, 10))

    if "relayout" in args.kernels:
        rows += relayout_turns(libs, dev)

    if "swimmer" in args.kernels:
        for links in SWIMMER_LINKS:
            c = SwimmerEnv(n_links=links, max_steps=100, device=dev).consts
            g = torch.Generator(dev).manual_seed(7)
            unif = lambda *shape: torch.rand(*shape, generator=g, device=dev) * 2 - 1
            N = 513
            state = (unif(N, c.ndof), unif(N, c.ndof),
                     torch.randint(0, 100, (N,), generator=g, device=dev),
                     1.5 * unif(N, c.n_links - 1))
            # gaussian_swimmer's launch, then the host topology's (its first episode)
            for n in (N, 1):
                ins = tuple(x[:n].contiguous() for x in state)
                outs = tuple(torch.empty_like(x) for x in sw.swimmer_step(c, *ins))

                def parent(c=c, ins=ins, outs=outs):
                    build.raise_on(libs["swimmer"].dfd_swimmer_step(
                        ctypes.byref(sw.kernel_args(c, ins, outs)), c.n_links, stream()),
                        "parent swimmer_step")
                    return outs

                change = lambda c=c, ins=ins: sw.swimmer_step(c, *ins)
                pairs = list(zip(parent(), change()))
                equal = all(torch.equal(x, y) for x, y in pairs)
                diff = max((x.double() - y.double()).abs().max().item() for x, y in pairs)
                name = f"swimmer_step N={n} {links} links"
                print(f"turns: {name}: the outputs equal bit for bit: {equal}; largest absolute "
                      f"difference {diff:.3g}", flush=True)
                rows.append(dict(turns(name, parent, change, 50 if links < 32 else 10, rounds=5),
                                 bit_equal=equal, max_abs_diff=diff))

    if "torso_tiled" in args.kernels:
        torch.backends.cudnn.allow_tf32 = False
        build.build(*build.sources())  # time_ms sizes its spin from a warm call
        rows += torso_tiled_turns(libs, args.parent, dev)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
