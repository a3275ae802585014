"""Build-and-load machinery for the port's native libraries.

Counterpart of ``raht3dgs_tpu/codec/_native.py``. Every library the port
loads through ctypes (the host RLGR coder built with g++, the CUDA kernels
built with nvcc) follows one lifecycle: compile the repository's source
into ``raht3dgs_tpu_torch/_build/`` on first use (or when the source, or
a header it includes, is newer than the binary), load it, and declare the
C signatures.

Unlike the JAX package, a failed build RAISES: a timing or a stream made
by a silent pure-Python substitute would describe the wrong code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)


def gxx_command(src: str, out: str, extra: Sequence[str] = ()) -> List[str]:
    return ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            *extra, src, "-o", out]


def nvcc_command(src: str, out: str) -> List[str]:
    """Route (b) of the port's kernels: a plain C interface for ``sm_90a``.
    No fast math: the kernels' compensated sums depend on IEEE rounding."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
            "-Xcompiler", "-fPIC", src, "-o", out]


class NativeLib:
    """Lazy builder/loader for one shared library built from ``src``."""

    def __init__(self, src: str, lib_name: str,
                 configure: Callable[[ctypes.CDLL], None],
                 command: Callable[[str, str], List[str]],
                 deps: Sequence[str] = ()):
        self.src = src
        # headers the source includes: an edit to one rebuilds the library
        self.deps = tuple(deps)
        self.lib_path = os.path.join(BUILD_DIR, lib_name)
        self._configure = configure
        self._command = command
        self._lib: Optional[ctypes.CDLL] = None
        # seconds the build took in this process (0.0: loaded a fresh binary)
        self.build_seconds = 0.0
        # compiler's stderr of that build (nvcc -Xptxas=-v resource report)
        self.build_log = ""

    def _stale(self) -> bool:
        if not os.path.exists(self.lib_path):
            return True
        built = os.path.getmtime(self.lib_path)
        return any(os.path.getmtime(s) > built for s in (self.src, *self.deps))

    def build(self) -> None:
        """Compile into a temporary name, then rename: concurrent test
        workers never load a half-written library."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(self._command(self.src, tmp),
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {os.path.basename(self.lib_path)} from "
                    f"{self.src} failed (rc={proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, self.lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            if self._stale():
                self.build()
            lib = ctypes.CDLL(self.lib_path)
            self._configure(lib)
            self._lib = lib
        return self._lib
