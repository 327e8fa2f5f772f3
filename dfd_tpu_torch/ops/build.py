"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.  Libraries are built at first use
into ``build/dfd_tpu_torch/`` at the root of the checkout, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is not.  Only the sources
in this package are compiled.  ``ptxas`` reports each kernel's registers,
shared memory and spills (``-Xptxas -v``);
the compiler's output is kept beside its library (:func:`compiler_log`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dfd_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def tool_path(tool: str = "nvcc") -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): under ``CUDA_HOME``
    (or ``CUDA_PATH``, else ``/usr/local/cuda``), else on the ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", tool)
    if os.path.exists(candidate):
        return candidate
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found: set CUDA_HOME to the CUDA toolkit")
    return found


def nvcc_path() -> str:
    return tool_path("nvcc")


def sass(name: str) -> str:
    """The SASS of the built library ``name`` (``cuobjdump -sass``)."""
    return subprocess.run([tool_path("cuobjdump"), "-sass", str(build(name)[0])],
                          capture_output=True, text=True, check=True).stdout


def library_path(name: str) -> Path:
    """Where the library ``name`` is built: named by a hash of its source,
    every shared header (``csrc/*.cuh``, which a source may include) and the
    flags, so an edit to any of them rebuilds it."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def sources() -> tuple:
    """The names of every ``csrc/*.cu``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def compiler_log(name: str) -> str:
    """What ``nvcc`` printed when it built the current library ``name``
    ("" if it is not built)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(*names: str) -> list:
    """Compile each ``csrc/<name>.cu`` whose current library does not exist,
    one ``nvcc`` process per source, all started together; returns the
    libraries' paths.  Each compiler writes a file of this process's own and
    renames it into place, so concurrent builds never see half a library;
    its output goes beside the library first."""
    jobs = []
    for name in names:
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            path.with_suffix(".log").write_text(log)
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(name) for name in names]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed (once per process)."""
    return ctypes.CDLL(str(build(name)[0]))


def raise_on(err: int, what: str) -> None:
    """Raise unless ``err``, the ``cudaGetLastError()`` a C entry point
    returns right after its launch, is 0."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")
