"""Build a kernel's CUDA source into a shared library and load it.

Every kernel of the port is CUDA C++ with a plain C entry point, compiled
at first use by ``nvcc`` into ``<repo>/build/kernels/`` (gitignored) and
bound with ctypes.  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs when a module is imported: the CPU
tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

# <repo>/build/kernels: <repo>/src/repro_torch/kernels/nvcc.py
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source on a machine with the CUDA toolkit")


class CudaLibrary:
    """One kernel source → one shared library, built once per content.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the library's C
    entry points; it runs once, when the library is first loaded.
    ``info`` holds the build's path, seconds and ``nvcc`` log (the
    ``-Xptxas=-v`` register and spill report)."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.name = self.source.stem
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.info = {"path": None, "seconds": None, "log": ""}

    def build(self) -> Path:
        """Compile into ``build/kernels/`` unless this exact source was
        built already; return the shared library's path."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
        out = BUILD_DIR / f"lib{self.name}_{digest}.so"
        if out.exists():
            self.info.update(path=str(out), seconds=0.0)
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(self.source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)              # atomic: concurrent builds agree
        self.info.update(path=str(out), seconds=time.perf_counter() - t0,
                         log=proc.stderr)
        return out

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if need be)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib
