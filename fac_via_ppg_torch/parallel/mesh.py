"""The (data x model) mesh of processes, on torch.distributed.

The port of fac_via_ppg_tpu/parallel/mesh.py.  JAX is single-controller:
one process drives every chip and GSPMD partitions one program.  PyTorch
runs one process per GPU (the reference's own scaling,
src/waveglow/distributed.py:43-170), so a mesh here is a grid of ranks:
rank r sits at data index r // model and model index r % model.  The ranks
that share a model index form the data group (batch rows are split over
it, gradients averaged over it); the ranks that share a data index form
the model group (WaveGlow's WN channels are split over it).  Each group is
its own `torch.distributed.new_group`.

The port uses three collectives only, `all_reduce`, `all_gather` and
`broadcast`, each counted in `collectives` where it is issued.  A mesh of
one process (no process group) issues none.

The caller picks the backend: NCCL for a CUDA device and gloo for the CPU
by default; gloo on CUDA tensors only when it is asked for.  Nothing falls
back from one to the other.  JAX's `normalize_tree_placement` repairs the
placement of optax's fresh scalars on a device mesh; the port's trees
never change placement, so it has no counterpart.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fac_via_ppg_torch.utils.numeric import round_up
from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map

# collectives issued by this process, by kind (a counter, like the
# kernels' `launches`)
collectives = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}

# dtypes neither gloo nor NCCL reduce or gather, carried as int32
_WIDEN = {torch.int16: torch.int32, torch.bool: torch.int32}


def local_device(device=None) -> torch.device:
    """This process's device: `device` when given, else cuda:LOCAL_RANK
    (LOCAL_RANK from the environment, else RANK, else 0).  A local rank at
    or above the card count raises: ranks never wrap round onto a shared
    card.  Raises when CUDA is asked for but absent."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    n = torch.cuda.device_count()
    if local >= n:
        raise ValueError(
            f"LOCAL_RANK {local} has no card of its own: this host has {n}; "
            f"launch at most {n} processes per host (torchrun "
            f"--nproc_per_node {n}), or pass device= explicitly")
    return torch.device("cuda", local)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device=None, timeout=None) -> torch.device:
    """Join (or form) the process group and return this process's device.

    The counterpart of JAX `scripts/multiproc.py::initialize_distributed`.
    With no arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT), as JAX auto-detects on Cloud
    TPU; with no environment either it is a one-process run and forms no
    group.  `init_method` is a `tcp://HOST:PORT` or `file://PATH`
    rendezvous for `world_size` processes, this one `rank`.  `backend`
    defaults to "nccl" for a CUDA device and "gloo" for the CPU;
    `timeout` (a timedelta) bounds each collective's wait.  A group
    already formed is kept (and nothing is printed again)."""
    if dist.is_initialized():
        return local_device(device)
    env = launched()
    if world_size is None and env:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and env:
        rank = int(os.environ["RANK"])
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is not None or env:
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size if world_size is not None else -1,
            rank=rank if rank is not None else -1,
            **({"timeout": timeout} if timeout is not None else {}),
            **({"device_id": device} if backend == "nccl" else {}))
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    print(f"process {me}/{world}, local devices: 1 ({device}), "
          f"global devices: {world}", flush=True)
    return device


def launched() -> bool:
    """True in a job of several processes: a process group is formed, or
    torchrun's environment names this process's rank."""
    return dist.is_initialized() or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def job_device(device=None) -> torch.device:
    """An entry point's device: in a launched job this process's own
    (`init_distributed`, which forms the group from torchrun's
    environment if need be), else `device` (None: the card)."""
    if launched():
        return init_distributed(device=device)
    from fac_via_ppg_torch.utils.device import resolve_device

    return resolve_device(device)


def all_stop(flag: bool, mesh: "Mesh") -> bool:
    """True on every rank when `flag` is True on any (a preemption notice
    reaches the ranks at different steps; they must stop at the same)."""
    if mesh.data_group is None and mesh.model_group is None:
        return flag
    t = torch.tensor([int(flag)], device=mesh.device)
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class Mesh:
    """A (data x model) grid of this job's ranks (see the module doc).

    `shape` is {"data": d, "model": m}, as JAX's `mesh.shape`;
    `data_rank` / `model_rank` are this rank's indices; `data_group` /
    `model_group` are the process groups its collectives run over (None
    on a mesh of one process, where nothing is issued)."""

    def __init__(self, data: int, model: int, device: torch.device,
                 rank: int = 0, data_group=None, model_group=None):
        self.shape = {"data": int(data), "model": int(model)}
        self.device = torch.device(device)
        self.rank = rank
        self.data_rank = rank // model
        self.model_rank = rank % model
        self.data_group = data_group
        self.model_group = model_group

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def __repr__(self):
        return (f"Mesh({self.shape['data']} data x {self.shape['model']} "
                f"model, rank {self.rank}, {self.device})")


_MESHES = {}


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The (data, model) mesh over every rank of the job (one process
    without a process group).  `data` defaults to world // model; the
    product must be the world size, or it raises, saying how to launch.
    Every rank must call it with the same shape (forming a group is a
    collective); a shape already formed is reused."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = int(model)
    if data is None:
        data = max(world // model, 1)
    data = int(data)
    if data * model != world or data < 1:
        raise ValueError(
            f"a mesh of {data} data x {model} model needs {data * model} "
            f"processes, but this job has {world}: launch one process per "
            f"GPU with torchrun --nproc_per_node {data * model} (or "
            f"python -m fac_via_ppg_torch.scripts.multiproc)")
    device = local_device(device)
    if not dist.is_initialized():
        return Mesh(data, model, device)
    # a group formed anew (after destroy_process_group) forms anew
    key = (id(dist.group.WORLD), data, model, str(device))
    if key not in _MESHES:
        rank = dist.get_rank()
        data_group = model_group = None
        # every rank forms every group, in the same order
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if rank % model == j:
                data_group = g
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if rank // model == i:
                model_group = g
        _MESHES[key] = Mesh(data, model, device, rank, data_group,
                            model_group)
    return _MESHES[key]


def rank_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n` rows padded to the data
    axis (`padded_rows`): a contiguous block, rank order."""
    b = padded_rows(mesh, n) // mesh.shape["data"]
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def padded_rows(mesh: Mesh, n: int) -> int:
    """`n` rounded up to a multiple of the data axis."""
    return round_up(n, mesh.shape["data"])


def _pad_rows(x, n_pad: int):
    reps = n_pad - x.shape[0]
    if reps <= 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(reps, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], reps, axis=0)])


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tree of arrays or tensors
    with a leading batch axis).  A batch that does not divide the data
    axis is padded with repeats of its last row first, as the JAX package
    pads (eval/fused.py:66-74); `gather_rows` trims them after.

    JAX's multi-process `shard_batch` takes each process's own rows and
    assembles the global array; here a process that already holds its own
    shard (the trainers' `EpochBatcher(shard=...)`) uses it as it is."""
    n = tree_leaves(batch)[0].shape[0]
    n_pad = padded_rows(mesh, n)
    rows = rank_rows(mesh, n)
    return tree_map(lambda x: _pad_rows(x, n_pad)[rows], batch)


def _group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as the backends take it: contiguous, int16 / bool widened."""
    wide = _WIDEN.get(t.dtype)
    return (t if wide is None else t.to(wide)).contiguous()


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum (or `op`) of `t` over `group`, in place; `t` itself with no
    group."""
    if group is None:
        return t
    collectives["all_reduce"] += 1
    w = _wire(t)
    dist.all_reduce(w, op=op or dist.ReduceOp.SUM, group=group)
    if w is not t:
        t.copy_(w)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` of `group`, concatenated along `dim` in rank
    order; `t` itself with no group."""
    if group is None:
        return t
    collectives["all_gather"] += 1
    src = _wire(t)
    parts = [torch.empty_like(src) for _ in range(_group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """`t` from the rank at index `src` of `group`, in place on every rank
    of it; `t` itself with no group."""
    if group is None:
        return t
    collectives["broadcast"] += 1
    w = _wire(t)
    dist.broadcast(w, src=dist.get_global_rank(group, src), group=group)
    if w is not t:
        t.copy_(w)
    return t


def gather_rows(mesh: Mesh, t: torch.Tensor, n_real: int) -> torch.Tensor:
    """The global batch from every rank's rows (`shard_batch`), its
    padding trimmed: (n_real, ...) on every rank."""
    return all_gather_cat(t, mesh.data_group)[:n_real]


def replicate(mesh: Mesh, tree):
    """Every tensor leaf broadcast from global rank 0, in place (JAX
    `replicate` places one array on every device): the ranks leave with
    rank 0's values.  The tree itself with no process group."""
    if mesh.data_group is None and mesh.model_group is None:
        return tree
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            collectives["broadcast"] += 1
            w = _wire(t)
            dist.broadcast(w, src=0)
            if w is not t:
                t.copy_(w)
    return tree


def barrier() -> None:
    """Wait for every rank of the job (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
