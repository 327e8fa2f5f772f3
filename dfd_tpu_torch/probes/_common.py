"""What the Hopper probes share: the match checks, one measured case and its row of results."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.utils.profiling import BYTES_RATE, bound, time_ms

# max |got - want| allowed on the card, relative to max(1, max |want|): data
# movement is exact; float32 products and chains sum in another order than
# PyTorch's; in bf16 an f32 intermediate one ulp apart can round to the
# neighbouring bf16 value: the chains' worst was 5.0e-5 (H100 80GB HBM3,
# 700 W), and the limit is 10x that
TOL_EXACT, TOL_F32, TOL_BF16 = 0.0, 1e-5, 5e-4


def probe_device(device=None) -> torch.device:
    """The card by default (``resolve_device``); ``device="cpu"`` runs the
    plain versions and times them on the host clock, a rehearsal only.  The
    plain versions are full float32, so TF32 is switched off for matrix
    products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve_device(device)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def check_match(case: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want|; raises unless the shapes agree and it is at most
    ``tol * max(1, max |want|)`` (exactly 0 for ``tol == 0``)."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{case}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    scale = max(1.0, float(want.float().abs().max())) if want.numel() else 1.0
    if not err <= tol * scale:  # also fails on NaN
        raise AssertionError(f"{case}: max |d| {err} exceeds {tol} x {scale}")
    return err


def check_nearer(case: str, got: torch.Tensor, want: torch.Tensor, other: torch.Tensor) -> None:
    """Raises unless ``got`` lies nearer ``want`` than ``other`` does (max
    |d|): a bf16 kernel's output must sit nearer the bf16 plain version than
    the float32 one, which a kernel that ignored its bf16 flag would not."""
    near = float((got.float() - want.float()).abs().max())
    far = float((got.float() - other.float()).abs().max())
    if not near < far:
        raise AssertionError(f"{case}: max |d| {near} to its plain version, {far} to the "
                             f"other one")


def measure(probe: str, case: str, kernel: str, run: Callable, plain: Callable, *,
            tol: float, flops: float, rate: float, nbytes: float, dev: torch.device, n: int,
            library: Optional[Callable] = None, plain_is_library: bool = False,
            other: Optional[Callable] = None) -> dict:
    """One probe case: ``run`` (the kernel's wrapper) against ``plain`` on
    the same inputs, then both timed (``n`` calls each after a warm call, the
    plain version fewer), and ``library`` (one PyTorch call computing the
    same function) where there is one.  Where ``other`` is given (the
    float32 plain version of a bf16 kernel), the kernel's output must also lie
    nearer ``plain``'s than ``other``'s.  On the card the kernel launches
    ``n + 2`` times: the checked call, the warm call and ``n`` timed ones (on
    the CPU the wrapper runs its plain version and launches nothing)."""
    got, want = run(), plain()
    err = check_match(f"{probe}: {case}", got, want, tol)
    if other is not None:
        check_nearer(f"{probe}: {case}", got, want, other())
    del got, want
    ms = time_ms(run, dev, n)
    plain_ms = time_ms(plain, dev, max(1, min(n, 5)))
    if plain_is_library:
        library_ms = plain_ms
    else:
        library_ms = time_ms(library, dev, n) if library is not None else None
    bound_ms, bound_by = bound(nbytes, (flops, rate))
    return {"probe": probe, "case": case, "kernel": kernel, "device": device_name(dev),
            "launches": n + 2 if dev.type == "cuda" else 0, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ops_ms": flops / rate * 1e3,
            "bytes_ms": nbytes / BYTES_RATE * 1e3}


def format_row(row: dict) -> str:
    lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    extra = "".join(f", {k} {v:.4g}" if isinstance(v, float) else f", {k} {v}"
                    for k, v in row.items() if k not in _BASE_KEYS)
    return (f"[{row['probe']}] {row['case']}: kernel {row['kernel']} {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {lib} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']}, max|d| {row['max_abs_err']:.3g}, launches "
            f"{row['launches']}{extra}")


_BASE_KEYS = ("probe", "case", "kernel", "device", "launches", "max_abs_err", "tol", "ms",
              "plain_ms", "library_ms", "bound_ms", "bound_by", "ops_ms", "bytes_ms")


def print_rows(rows) -> None:
    if rows:
        print(f"device: {rows[0]['device']}", flush=True)
    for row in rows:
        print(format_row(row), flush=True)
