"""Host-to-device prefetching (the port of
fac_via_ppg_tpu/data/prefetch.py).

A background thread collates batch N+1 and copies it to the device while
step N runs.  `to_device(device)` is the usual `place`: each array goes
into pinned host memory and is copied `non_blocking` on the current
stream, which the training step then uses."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def to_device(device: torch.device, dtypes: Optional[dict] = None):
    """`place` for `prefetch`: a batch tuple of arrays -> tensors on
    `device`, through pinned memory on a card.  `dtypes` maps an element's
    index to the dtype it is cast to on the host."""
    dtypes = dtypes or {}
    pin = device.type == "cuda"

    def place(batch):
        out = []
        for i, x in enumerate(batch):
            t = torch.as_tensor(np.asarray(x))
            if i in dtypes:
                t = t.to(dtypes[i])
            if pin:
                t = t.pin_memory()
            out.append(t.to(device, non_blocking=pin))
        return tuple(out)

    return place


class PrefetchIterator:
    """Wraps a batch iterable and materializes up to `depth` batches
    ahead; `place` runs in the worker thread."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, place: Optional[Callable] = None,
                 depth: int = 2):
        self._iterable = iterable
        self._place = place or (lambda x: x)
        self._depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        error = []
        abandoned = threading.Event()

        def put(item) -> bool:
            # bounded, so that an abandoned consumer cannot leave the
            # worker blocked forever holding device batches
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._iterable:
                    if not put(self._place(item)):
                        return
            except BaseException as e:  # raised in the consumer
                error.append(e)
            finally:
                put(self._SENTINEL)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            abandoned.set()


def prefetch(iterable: Iterable, place: Optional[Callable] = None,
             depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, place, depth)
