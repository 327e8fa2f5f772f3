"""Build hook: compile the native C++ env pool into the wheel.

The pool (runtime/envpool.cc) is a plain C-ABI shared library loaded via
ctypes (dfd_tpu/envs/native_pool.py, and the port's
dfd_tpu_torch/envs/native_pool.py), not a Python extension module, so the
build step is a direct g++ invocation rather than setuptools.Extension.
The build is best-effort: without a C++ toolchain the wheel still works —
the pool is availability-gated and the pure-Python vector env is used.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        super().run()
        root = os.path.dirname(os.path.abspath(__file__))
        runtime = os.path.join(root, "runtime")
        lib = os.path.join(runtime, "libdfd_envpool.so")
        # Wheels are distributable artifacts: build for a generic baseline,
        # not the build host's ISA (-march=native can SIGILL elsewhere).
        env = dict(os.environ)
        env.setdefault("DFD_MARCH", "x86-64-v2")
        try:
            subprocess.run(["sh", os.path.join(runtime, "build.sh")], check=True, env=env)
        except Exception as exc:  # toolchain missing: ship without the pool
            print(f"warning: native env pool not built ({exc}); "
                  "the pure-Python vector env will be used")
            return
        for package in ("dfd_tpu", "dfd_tpu_torch"):  # each package loads its own copy
            dest = os.path.join(self.build_lib, package, "_native")
            os.makedirs(dest, exist_ok=True)
            shutil.copy2(lib, dest)


setup(cmdclass={"build_py": build_py_with_native})
