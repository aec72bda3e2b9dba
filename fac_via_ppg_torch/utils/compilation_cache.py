"""Where the port's compiled libraries live across processes.

The JAX package points JAX's persistent compilation cache at a directory
so that a restarted process skips its XLA compiles.  What the port
compiles is its libraries: the hand kernels' nvcc builds
(`ops/cuda_lib.py`, `lib{wn_layer,wn_flow}.so`) and the native MFCC's g++
build (`native.py`, `libfacppg_native.so`).  Each is built at first use
and reused by every later process while it is newer than its sources.
By default they live in `fac_via_ppg_torch/build/`;
`enable_compilation_cache` points both lookups at another directory (a
volume shared by the replicas of a deployment, say), and
`disable_compilation_cache` points them back.  Opt in through
``--compilation_cache_dir`` on the serving CLIs,
``hparams.compilation_cache_dir`` in the trainers, or the
``FACPPG_COMPILATION_CACHE`` environment variable.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_ENV_VAR = "FACPPG_COMPILATION_CACHE"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


def _point_libraries_at(directory: Path) -> None:
    from fac_via_ppg_torch import native
    from fac_via_ppg_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR = directory
    native.LIBRARY = directory / native.LIBRARY.name


def enable_compilation_cache(cache_dir: Optional[str] = None
                             ) -> Optional[str]:
    """Build and look up the compiled libraries in ``cache_dir``.

    ``cache_dir`` falls back to ``$FACPPG_COMPILATION_CACHE``; if neither
    is set this is a no-op returning None.  Otherwise the directory is
    created, the kernel libraries and the native MFCC library are looked
    up there from now on (a library already loaded in this process stays
    loaded), and the resolved absolute path is returned.  Idempotent."""
    cache_dir = cache_dir or os.environ.get(_ENV_VAR) or None
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _point_libraries_at(Path(cache_dir))
    return cache_dir


def disable_compilation_cache() -> None:
    """Point the lookups back at the package's build/ (tests use this to
    un-leak)."""
    _point_libraries_at(DEFAULT_BUILD_DIR)
