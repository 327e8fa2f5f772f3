"""What the swimmer kernel's lanes an episode and episodes a block give, on
one card: copies of ``dfd_tpu_torch/ops/csrc/swimmer.cu`` with those two
constants changed in the text; and where the run-time form's time goes.

    python3 tools/torch_swimmer_variants.py [--parent DIR] [--out FILE]

Builds, with the same ``nvcc`` flags as ``dfd_tpu_torch/ops/build.py`` and
all at once, copies of this checkout's ``swimmer.cu`` into
``build/swimmer_variants/``: ``G lanes x E`` for G = 32 and 16 lanes an
episode (``kLanes``) and E episodes a block (``kEpisodes``) of one warp and
of four (the source's own choice, 32 x 4, among them); ``reversed back
substitution``, each row's terms summed from the last column down, so the
newest unknown comes last (the source keeps the JAX package's increasing
order); ``exact``, every substep on the compiler's division and sqrtf
(the source's fallback) in place of their branch-free fast paths, which
must give the same outputs bit for bit; ``smid``, the source as it is with each episode's step counter
replaced by the SM it ran on (``%smid``), which counts the SMs a launch
covers; and ``stamps``, the source as it is with thread 0 of block 0
reading ``clock64()`` after each phase and each lane-local step, which
gives the cycles of each phase of the first episode's step.  The stamps
are also read from the run-time form (``swimmer_step_dyn_kernel``) at 15
and 30 links (its register forms) and 32 and 64 (its shared-memory form),
N = 513, and, with ``--parent DIR`` (the root of another
checkout, unpacked with ``git archive``), from that checkout's
``swimmer.cu`` built with the same stamps: each phase's cycles summed over
the step's substeps (the factor's columns and their updates summed as one
phase each), which attributes the old and the new time.  Each copy's outputs
at ``gaussian_swimmer``'s 513 episodes of 7 links (random states and
actions, as ``tools/torch_kernel_turns.py`` draws them) and at the host
topology's one episode are compared with the wrapper's (bit for bit, and
the largest absolute difference), then every copy and the wrapper are timed
(``time_ms``, 50 calls) in five rounds, forward and backward through them.
Prints ptxas's registers and shared memory of each copy's 7-link form, one
line a case with each copy's median and range, the cycles of each phase
(``stamps``, one launch after a warm one, at each N; clock64's own cost
included), and writes them as JSON to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dfd_tpu_torch.envs import SwimmerEnv  # noqa: E402
from dfd_tpu_torch.ops import build  # noqa: E402
from dfd_tpu_torch.ops import swimmer as sw  # noqa: E402
from dfd_tpu_torch.utils.profiling import time_ms  # noqa: E402

LANES = "constexpr int kLanes = 32;"
EPISODES = "constexpr int kEpisodes = 4;"
T_OUT = "a.t_out[e] = r.t;"
SMID = ('unsigned smid; asm volatile("mov.u32 %0, %%smid;" : "=r"(smid)); '
        "a.t_out[e] = smid;")
SHAPES = ((32, 4), (32, 1), (16, 8), (16, 2))  # (lanes, episodes a block; a template form's
                                               # lanes hold a link each: at least kFormLinks)
BACK = "for (int k = i + 1; k < ND; ++k) acc = acc - r.Lc[k][i] * r.v[k];"
FAST = "substep<NL, Fast>(a, s, g);"
EXACT = "substep<NL, Exact>(a, s, g);"
BACK_REVERSED = "for (int k = ND - 1; k > i; --k) acc = acc - r.Lc[k][i] * r.v[k];"
# the stamps: a clock64() after each phase and each lane-local step of the first episode
GROUP = "  int lane;\n  unsigned mask;\n"
GROUP_STAMPS = ("  int lane;\n  unsigned mask;\n  int nstamp = 0;\n"
                "  __device__ void stamp() {\n"
                "    if (threadIdx.x == 0 && blockIdx.x == 0 && nstamp < 4096) "
                "dfd_stamps[nstamp] = clock64();\n"
                "    ++nstamp;\n  }\n")
EACH = "void each(F&& f) { f(lane, r); }"
EACH_STAMPS = "void each(F&& f) { f(lane, r); stamp(); }"
PHASE = "    __syncwarp(mask);\n"
PHASE_STAMPS = "    __syncwarp(mask);\n    stamp();\n"
KERNEL = "  swimmer_episode<NL>(a, e, scratch[slot], g);"
KERNEL_STAMPS = "  g.stamp();\n  swimmer_episode<NL>(a, e, scratch[slot], g);"
DYN_KERNEL = re.compile(r"\n(\s*)(swimmer_episode_(?:dyn|cap<CAP>)\(a, e, )")
STAMPS_HEAD = "#ifdef __CUDACC__\n// On the card a lane is a thread"
STAMPS_DEF = ("#ifdef __CUDACC__\n__device__ long long dfd_stamps[4096];\n"
              "// On the card a lane is a thread")
DYN_LINKS = (15, 30, 32, 64)  # the run-time form's stamps: two register forms, the shared one
STAMPS_ENTRY = """
extern "C" int dfd_swimmer_stamps(long long* out) {
  return int(cudaMemcpyFromSymbol(out, dfd_stamps, sizeof(dfd_stamps)));
}
"""


def with_stamps(src: str) -> str:
    """``src`` with thread 0 of block 0 reading clock64() after each phase."""
    for part in (GROUP, EACH, PHASE, KERNEL, STAMPS_HEAD):
        if part not in src:
            raise RuntimeError(f"swimmer.cu no longer holds {part!r}")
    for old, new in ((GROUP, GROUP_STAMPS), (EACH, EACH_STAMPS), (PHASE, PHASE_STAMPS),
                     (KERNEL, KERNEL_STAMPS), (STAMPS_HEAD, STAMPS_DEF)):
        src = src.replace(old, new, 1)
    # the run-time kernel's two calls (the shared-memory form's, the register forms'), which
    # come before the host entry's
    return DYN_KERNEL.sub(lambda m: f"\n{m[1]}g.stamp();\n{m[1]}{m[2]}", src, 2) + STAMPS_ENTRY


def build_variants(parent=None) -> dict:
    src = (ROOT / "dfd_tpu_torch" / "ops" / "csrc" / "swimmer.cu").read_text()
    for part in (LANES, EPISODES, T_OUT, BACK, FAST):
        if part not in src:
            raise RuntimeError(f"swimmer.cu no longer holds {part!r}")
    sources = {f"{g} lanes x {e}": src.replace(LANES, f"constexpr int kLanes = {g};")
               .replace(EPISODES, f"constexpr int kEpisodes = {e};") for g, e in SHAPES}
    sources["reversed back substitution"] = src.replace(BACK, BACK_REVERSED)
    sources["exact"] = src.replace(FAST, EXACT)
    sources["smid"] = src.replace(T_OUT, SMID)
    sources["stamps"] = with_stamps(src)
    if parent is not None:
        sources["parent stamps"] = with_stamps(
            (parent / "dfd_tpu_torch" / "ops" / "csrc" / "swimmer.cu").read_text())
    out_dir = ROOT / "build" / "swimmer_variants"
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
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = next(e for e in log.split("Compiling entry function")
                     if "swimmer_step_kernelILi7E" in e)
        regs = re.search(r"Used (\d+) registers", entry)[1]
        smem = (re.search(r"(\d+) bytes smem", entry) or [0, 0])[1]
        print(f"variants: built {name}: swimmer_step_kernel<7> {regs} registers, {smem} bytes "
              f"of shared memory a block", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].dfd_swimmer_step.argtypes = [ctypes.POINTER(sw._Args), ctypes.c_int,
                                                ctypes.c_void_p]
        libs[name].dfd_swimmer_step.restype = ctypes.c_int
    for name in ("stamps", "parent stamps"):
        if name in libs:
            libs[name].dfd_swimmer_stamps.argtypes = [ctypes.c_void_p]
            libs[name].dfd_swimmer_stamps.restype = ctypes.c_int
    return libs


def dyn_phases(nd: int, frame_skip: int, form: str) -> list:
    """The run-time form's phases in the order its stamps come: the step's
    own, then each substep's.  ``form``: ``registers`` (a column a phase,
    the diagonal's exchange one), ``shared`` (a column and its update a
    phase each) or ``parent`` (the left-looking form: a column a phase)."""
    if form == "registers":
        sub = ["save", "angles", "links", "assembly", "rhs", "diagonal"] + [
            f"column {k}" for k in range(nd)] + ["back"]
    elif form == "shared":
        sub = ["save", "angles", "links", "assembly", "rhs"] + [
            x for k in range(nd) for x in (f"column {k}", f"update {k}")][:-1] + [
            "back", "q += dt v"]
    else:
        sub = ["save", "angles", "links", "assembly", "rhs"] + [
            f"column {k}" for k in range(nd)] + ["back"]
    return ["load", "ctrl", "com_x (dx)", "com_x (sum)"] + sub * frame_skip + [
        "com_x (dx)", "com_x (sum)", "outputs"]


def dyn_cycles(lib, c, ins, who: str) -> dict:
    """The run-time form's phases in cycles for the first episode: each kind
    of phase summed over the step's substeps."""
    outs = tuple(torch.empty_like(x) for x in sw.swimmer_step(c, *ins))
    for _ in range(2):  # a warm launch, then the one read
        build.raise_on(lib.dfd_swimmer_step(ctypes.byref(sw.kernel_args(c, ins, outs)),
                                            c.n_links, torch.cuda.current_stream().cuda_stream),
                       "swimmer stamps")
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 4096)()
    build.raise_on(lib.dfd_swimmer_stamps(buf), "swimmer stamps")
    form = "parent" if who == "parent" else "registers" if c.ndof <= 32 else "shared"
    names = dyn_phases(c.ndof, c.frame_skip, form)
    cycles = [buf[i + 1] - buf[i] for i in range(len(names))]
    kind = lambda n: n.split()[0] if n.split()[0] in ("column", "update") else n
    summed = {}
    for n, x in zip(names, cycles):
        summed[kind(n)] = summed.get(kind(n), 0) + x
    total = buf[len(names)] - buf[0]
    print(f"variants: {who} run-time form ({form}) {c.n_links} links N={ins[0].shape[0]} stamps: "
          f"{total} "
          f"cycles from the first stamp to the last; each kind of phase over the step "
          f"({c.frame_skip} substeps, the columns and updates summed): {summed}", flush=True)
    return {"case": f"{c.n_links} links N={ins[0].shape[0]}", "variant": f"{who} stamps",
            "total_cycles": total, "phases": summed, "cycles": cycles}


def phase_cycles(lib, call, n: int, ndof: int, frame_skip: int) -> dict:
    """The first episode's phases in cycles (``stamps``, the launch after
    ``call``'s warm one): each phase of the first substep, and each summed
    over the substeps."""
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 4096)()
    build.raise_on(lib.dfd_swimmer_stamps(buf), "swimmer stamps")
    sub = ["save", "angles", "links", "assembly", "column 0"] + [
        f"column {k}" for k in range(1, ndof - 1)] + [f"column {ndof - 1}, back substitution"]
    names = ["load", "com_x (dx)", "com_x (sum)"] + sub * frame_skip + [
        "com_x (dx)", "com_x (sum)", "outputs"]
    cycles = [buf[i + 1] - buf[i] for i in range(len(names))]
    first = dict(zip(sub, cycles[3:3 + len(sub)]))
    summed = {k: sum(cycles[3 + i + j * len(sub)] for j in range(frame_skip))
              for i, k in enumerate(sub)}
    total = buf[len(names)] - buf[0]
    print(f"variants: N={n} stamps: {total} cycles from the first stamp to the last; the first "
          f"substep's phases {first}; each phase over the {frame_skip} substeps {summed}; "
          f"outside the substeps: {dict(zip(names[:3], cycles[:3]))}, "
          f"{dict(zip(names[-3:], cycles[-3:]))}", flush=True)
    return {"case": f"N={n}", "variant": "stamps", "total_cycles": total,
            "first_substep": first, "substeps": summed, "cycles": cycles}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout: its stamps too")
    ap.add_argument("--out", default=str(ROOT / "build" / "swimmer_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_swimmer_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_variants(args.parent)
    dev = torch.device("cuda")
    c = SwimmerEnv(max_steps=100, device=dev).consts
    g = torch.Generator(dev).manual_seed(7)
    unif = lambda *shape: torch.rand(*shape, generator=g, device=dev) * 2 - 1
    N = 513
    state = (unif(N, c.ndof), unif(N, c.ndof),
             torch.randint(0, 100, (N,), generator=g, device=dev), 1.5 * unif(N, c.n_links - 1))
    rows = []
    for n in (N, 1):
        ins = tuple(x[:n].contiguous() for x in state)
        want = sw.swimmer_step(c, *ins)
        calls = {"wrapper": lambda: sw.swimmer_step(c, *ins)}
        for name, lib in libs.items():
            outs = tuple(torch.empty_like(x) for x in want)

            def call(lib=lib, outs=outs):
                build.raise_on(lib.dfd_swimmer_step(ctypes.byref(sw.kernel_args(c, ins, outs)),
                                                    c.n_links,
                                                    torch.cuda.current_stream().cuda_stream),
                               "swimmer variant")
                return outs

            got = call()
            torch.cuda.synchronize()
            if name == "parent stamps":
                continue
            if name == "stamps":
                rows.append(phase_cycles(lib, call, n, c.ndof, c.frame_skip))
                continue
            if name == "smid":
                sms = len(torch.unique(got[2]))
                print(f"variants: N={n}: the launch's episodes ran on {sms} SMs", flush=True)
                rows.append({"case": f"N={n}", "sms": sms})
                continue
            pairs = list(zip(got, want))
            diff = max((x.double() - y.double()).abs().max().item() for x, y in pairs)
            print(f"variants: N={n} {name}: outputs equal to the wrapper's bit for bit: "
                  f"{all(torch.equal(x, y) for x, y in pairs)}; largest absolute difference "
                  f"{diff:.3g}", flush=True)
            calls[name] = call
        times = {name: [] for name in calls}
        order = list(calls)
        for r in range(5):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_ms(calls[name], dev, 50))
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"variants: N={n} {name}: median {med * 1e3:.3f} us a launch (range "
                  f"{min(ts) * 1e3:.3f}-{max(ts) * 1e3:.3f})", flush=True)
            rows.append({"case": f"N={n}", "variant": name, "median_ms": med, "ms": ts})
    for links in DYN_LINKS:
        c = SwimmerEnv(n_links=links, max_steps=100, device=dev).consts
        ins = (unif(N, c.ndof), unif(N, c.ndof),
               torch.randint(0, 100, (N,), generator=g, device=dev), 1.5 * unif(N, c.n_links - 1))
        for who in ("change", "parent"):
            lib = libs.get("stamps" if who == "change" else "parent stamps")
            if lib is not None:
                rows.append(dyn_cycles(lib, c, ins, who))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
