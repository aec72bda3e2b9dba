"""ctypes binding of the native host-side MFCC (native/src/frontend.cc).

The port's own loader for the C++ front end that the JAX package loads
through its `native` package (a copy of what the MFCC needs: the library's
C ABI for `fac_num_frames` / `fac_mfcc_compute` and `supports`).  The
library is built at first use with g++ (the flags of native/Makefile)
into `fac_via_ppg_torch/build/libfacppg_native.so` (git-ignored; another
directory under utils/compilation_cache.py), and rebuilt when the source
is newer.  Nothing is built or loaded at import.

    from fac_via_ppg_torch import native
    if native.available():
        feats = native.mfcc_compute(wav, fs, opts)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "src" \
    / "frontend.cc"
LIBRARY = Path(__file__).resolve().parent / "build" / "libfacppg_native.so"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

# MFCC calls served by the library since the last reset (the caller sets
# it to 0).
calls = 0

_WINDOW_TYPES = {"povey": 0, "hanning": 1, "hamming": 2, "rectangular": 3}


def _build() -> None:
    """Compile SOURCE into LIBRARY through a temporary file, so that a
    concurrent loader never sees half a library."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found")
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}")
    subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, LIBRARY)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        stale = (not LIBRARY.exists()
                 or (SOURCE.exists()
                     and SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime))
        if stale:
            try:
                _build()
            except (subprocess.SubprocessError, OSError):
                if not LIBRARY.exists():
                    _build_failed = True
                    return None  # no toolchain and no binary
        try:
            lib = ctypes.CDLL(str(LIBRARY))
        except OSError:
            _build_failed = True
            return None
        lib.fac_num_frames.restype = ctypes.c_int
        lib.fac_num_frames.argtypes = [
            ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.fac_mfcc_compute.restype = ctypes.c_int
        lib.fac_mfcc_compute.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it if needed) and loaded."""
    return _load() is not None


def supports(opts) -> bool:
    """Whether the native path implements this exact option combination
    (frontend/mfcc.py's MfccOptions); others take numpy rather than
    computing something different."""
    fo = opts.frame_opts
    return (
        fo.window_type in _WINDOW_TYPES
        and fo.round_to_power_of_two
        and (not opts.use_energy or (opts.raw_energy
                                     and opts.energy_floor == 0.0))
    )


def mfcc_compute(wav: np.ndarray, fs: float, opts, seed: int = 0
                 ) -> Optional[np.ndarray]:
    """Native MFCC matching frontend/mfcc.py's compute_mfcc (dither from
    the library's own seeded generator); None if the library is
    unavailable or the options fall outside `supports`.  Resampling is
    the caller's."""
    global calls
    if not supports(opts):
        return None
    lib = _load()
    if lib is None:
        return None
    fo = opts.frame_opts
    wav = np.ascontiguousarray(wav, dtype=np.float64)
    n_frames = lib.fac_num_frames(
        len(wav), fo.samp_freq, fo.frame_shift_ms, fo.frame_length_ms,
        int(fo.snip_edges),
    )
    if n_frames <= 0:
        return np.zeros((0, opts.num_ceps), np.float32)
    out = np.empty((n_frames, opts.num_ceps), np.float32)
    written = lib.fac_mfcc_compute(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(wav),
        fo.samp_freq, fo.frame_shift_ms, fo.frame_length_ms, fo.dither,
        fo.preemph_coeff, int(fo.remove_dc_offset),
        _WINDOW_TYPES[fo.window_type], int(fo.snip_edges),
        opts.mel_opts.num_bins, opts.mel_opts.low_freq,
        opts.mel_opts.high_freq, opts.num_ceps, int(opts.use_energy),
        opts.cepstral_lifter, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if written != n_frames:
        return None
    with _lock:
        calls += 1
    return out
