"""Build and load the port's hand-written CUDA kernels.

Each kernel's source `csrc/<name>.cu` (with the shared headers
`csrc/*.cuh`) is compiled by nvcc for sm_90a at first use into
`BUILD_DIR/lib<name>.so` and loaded with ctypes.  `BUILD_DIR` is
`fac_via_ppg_torch/build/` (git-ignored) unless
utils/compilation_cache.py points it elsewhere.  Nothing is built or
loaded at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"


class CudaLibrary:
    """One kernel library: `symbols` maps each exported C function to its
    ctypes argtypes (every function returns an int CUDA error code)."""

    def __init__(self, name: str, symbols: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._symbols = symbols
        self._lock = threading.Lock()
        self._lib = None

    @property
    def library(self) -> Path:
        """The built library's path, in the current BUILD_DIR."""
        return BUILD_DIR / f"lib{self.name}.so"

    def build(self) -> str:
        """Compile the source into `library`; returns nvcc's resource
        report (ptxas registers, shared memory and spills per kernel)."""
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(
                f"nvcc not found: {self.source.name} cannot be built")
        self.library.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_name(f".{self.library.name}.{os.getpid()}")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, self.library)
        return res.stderr

    def _stale(self) -> bool:
        if not self.library.exists():
            return True
        newest = max(p.stat().st_mtime
                     for p in (self.source, *CSRC.glob("*.cuh")))
        return self.library.stat().st_mtime < newest

    def occupancy(self, symbol: str) -> tuple:
        """The two ints of a C query `symbol(int*, int*)` about a kernel on
        the current card: (blocks per SM, dynamic shared memory bytes), or
        for a clustered kernel (cluster size, clusters held at once)."""
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = self.function(symbol)(ctypes.byref(blocks), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"{symbol} failed: CUDA error {err}")
        return blocks.value, smem.value

    def function(self, symbol: str):
        """The loaded C function, building the library first if needed."""
        with self._lock:
            if self._lib is None:
                if self._stale():
                    self.build()
                lib = ctypes.CDLL(str(self.library))
                for name, argtypes in self._symbols.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return getattr(self._lib, symbol)
