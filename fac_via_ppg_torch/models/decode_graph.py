"""CUDA graphs for Tacotron2's autoregressive decode.

The JAX package runs the decode as one device `lax.while_loop`.  The
port's counterpart is a chunk of k decode steps
(`models/tacotron2.py::decode_chunk`, a pure tensor function) captured
once with `torch.cuda.graph` on static buffers and replayed until the
stop holds; the host reads the stop once per chunk.

A graph bakes in the addresses of every tensor it touches and the
kernels cuBLAS / cuDNN chose at capture, so the cache key holds what a
capture depends on (the caller's shapes, dtype, device, chunk length,
TF32 state and the weights' addresses), and each entry keeps the weights
it captured alive, so that no address in a key can be reused while its
graph exists.  The cache is bounded (`MAX_GRAPHS`, least recently used
first out): each entry holds its static buffers and its graph's memory
pool, and serving sees few shapes (features are bucketed by 64 frames).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import torch

MAX_GRAPHS = 8

# Graphs captured and chunk replays since the last reset (the caller sets
# them to 0).
captures = 0
replays = 0

_cache: "OrderedDict[tuple, ChunkGraph]" = OrderedDict()
_lock = threading.Lock()


class ChunkGraph:
    """One call of `fn` captured as a CUDA graph.  `fn` reads and writes
    only tensors that outlive the graph (`static`, kept here)."""

    def __init__(self, fn: Callable[[], None], static):
        self.static = static
        # held by the caller from copying its inputs in to reading the
        # outputs out: the static buffers serve one decode at a time
        self.lock = threading.Lock()
        # warm up on a side stream (cuBLAS / cuDNN pick their kernels and
        # workspaces), then capture; `thread_local` lets other threads
        # (a server's front end) keep using the card meanwhile
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            fn()

    def replay(self) -> None:
        global replays
        replays += 1
        self.graph.replay()


def cached(key: tuple, make: Callable[[], ChunkGraph]) -> ChunkGraph:
    """The graph under `key`, captured by `make()` on a miss.  A failed
    capture raises: there is no eager fallback on the card."""
    global captures
    with _lock:
        entry = _cache.pop(key, None)
        if entry is None:
            entry = make()
            captures += 1
        _cache[key] = entry
        while len(_cache) > MAX_GRAPHS:
            _cache.popitem(last=False)
        return entry


def count() -> int:
    """Graphs held in the cache."""
    return len(_cache)


def clear() -> None:
    """Drop every cached graph (and its memory pool)."""
    with _lock:
        _cache.clear()
