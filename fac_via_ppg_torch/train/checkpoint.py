"""Checkpoint save / load / warm start (the port of
fac_via_ppg_tpu/train/checkpoint.py; reference train_ppg2mel.py:122-149,
train_waveglow.py:45-64).

A checkpoint is one `torch.save` file holding the JAX package's payload
keys: {iteration, learning_rate, params, opt_state, model_state}, every
tensor on the CPU.  `opt_state` is the torch.optim.Adam's state_dict.  The
JAX package writes orbax directories instead; the two formats do not read
each other (ROADMAP queue 3).

Under data parallelism (`mesh=`) every rank builds the payload (ZeRO-1's
moments are gathered, a collective) and rank 0 alone writes it (JAX
`process_index() == 0`); the file is the one a single process writes, so
a run saved at one world size resumes at any other.  The other ranks wait
at a barrier until it has landed.  Under tensor parallelism (`tp=`,
parallel/tp.py) every rank also gathers the params over its model group
(`TensorParallel.gather`), and ZeroAdam's state_dict the moments over
both axes, so the file holds whole tensors and a run saved at one (data
x model) mesh resumes at any other, or in one process."""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch

from fac_via_ppg_torch.parallel.mesh import barrier
from fac_via_ppg_torch.utils.tree import tree_map


def _to_host(tree):
    return tree_map(lambda x: x.detach().cpu()
                    if isinstance(x, torch.Tensor) else x, tree)


def _opt_payload(opt_state):
    """An Adam (or its state_dict) -> its state_dict."""
    return opt_state.state_dict() if hasattr(opt_state, "state_dict") \
        else opt_state


def _is_writer(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def save_checkpoint(path: str, params, opt_state, learning_rate: float,
                    iteration: int, model_state=None, mesh=None,
                    tp=None) -> None:
    """Write {iteration, learning_rate, params, opt_state} (+ the BN state)
    to `path`, through a temporary file renamed into place.  With a
    `mesh`, every rank calls it, rank 0 writes and the others wait; `tp`
    gathers the params' slices whole first."""
    if tp is not None:
        params = tp.gather(params)
    payload = _payload(params, opt_state, learning_rate, iteration,
                       model_state)
    if _is_writer(mesh):
        _write(path, payload)
    if mesh is not None:
        barrier()


def _write(path: str, payload: dict) -> None:
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _payload(params, opt_state, learning_rate, iteration, model_state):
    payload = {
        "iteration": int(iteration),
        "learning_rate": float(learning_rate),
        "params": _to_host(params),
        "opt_state": _to_host(_opt_payload(opt_state)),
    }
    if model_state is not None:
        payload["model_state"] = _to_host(model_state)
    return payload


class AsyncCheckpointSaver:
    """Checkpoint saves off the training thread.

    `save()` snapshots the trees with one on-device copy of each tensor
    (the optimizer updates the params and its moments in place, so the
    snapshot must be its own memory), then reads them back and writes on
    a background thread; training goes on meanwhile.  At most one save is
    in flight: a new `save()` joins the previous one first.  A failed
    save is reported by the next `save()` (as a warning, so that the
    current state is still written) and raised by `wait()`; call `wait()`
    before the process exits.

    With a `mesh` every rank calls `save` (the snapshot gathers ZeRO-1's
    moments, and with `tp` the params' slices) and `wait`; rank 0 alone
    writes, and `wait` holds every rank at a barrier until the last save
    has landed."""

    def __init__(self, mesh=None, tp=None):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh, self._tp = mesh, tp

    def _join(self) -> Optional[BaseException]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        return err

    def save(self, path: str, params, opt_state, learning_rate: float,
             iteration: int, model_state=None) -> None:
        prev_err = self._join()
        if prev_err is not None:
            print("WARNING: previous async checkpoint save failed "
                  f"({prev_err!r}); continuing with the current save")
        if self._tp is not None:
            params = self._tp.gather(params)
        snap = tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
            else x, (params, _opt_payload(opt_state), model_state))
        if not _is_writer(self._mesh):
            return

        def job():
            try:
                _write(path, _payload(snap[0], snap[1], learning_rate,
                                      iteration, snap[2]))
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=job, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        err = self._join()
        if self._mesh is not None:
            barrier()
        if err is not None:
            raise err


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, every tensor on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["iteration"] = int(payload["iteration"])
    payload["learning_rate"] = float(payload["learning_rate"])
    return payload


def warm_start(path: str):
    """The params alone (reference warm_start_model)."""
    return load_checkpoint(path)["params"]


def find_latest_checkpoint(output_directory: str,
                           prefix: str = "checkpoint_") -> Optional[str]:
    """The highest-iteration checkpoint `<prefix><iteration>` under a run
    directory, or None (for `checkpoint_path='auto'`)."""
    if not os.path.isdir(output_directory):
        return None
    best_iter, best_path = -1, None
    for name in os.listdir(output_directory):
        m = re.fullmatch(re.escape(prefix) + r"(\d+)", name)
        path = os.path.join(output_directory, name)
        if m and os.path.isfile(path) and int(m.group(1)) > best_iter:
            best_iter, best_path = int(m.group(1)), path
    return best_path
