"""Run a function on N spawned ranks of one process group, on one host.

`run_ranks(world, fn, *args)` starts `world` processes, joins them in one
group through a `file://` store (never a TCP port, so that several jobs
on one host cannot collide), calls `fn(rank, world, *args)` in each and
returns their results in rank order.  A rank's exception, with its
traceback, or the time limit fails the call; every process is stopped
before it returns.  It is how the multi-process checks drive the port on
the CPU (gloo) and on a card; a real job is launched by torchrun or
scripts/multiproc.py, one process per GPU.

`fn` must be picklable by reference (a module-level function), and so
must its arguments and its result.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

import torch

from fac_via_ppg_torch.parallel.mesh import init_distributed


def _rank_entry(rank, world, out_dir, fn, args, backend, device, threads,
                collective_timeout):
    """One spawned rank: its group (`backend` through out_dir's file
    store), `fn(rank, world, *args)`, and its result or its traceback
    saved to out_dir/rank<r>.pt."""
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    if isinstance(device, (list, tuple)):
        device = device[rank]
    try:
        init_distributed(
            backend=backend, init_method=f"file://{out_dir}/store",
            world_size=world, rank=rank, device=device,
            timeout=None if collective_timeout is None
            else datetime.timedelta(seconds=collective_timeout))
        result = {"ok": fn(rank, world, *args)}
    except BaseException:
        result = {"error": traceback.format_exc()}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if "error" in result:
        # tells the parent to stop the ranks still waiting on this one
        open(os.path.join(out_dir, f"rank{rank}.failed"), "w").close()
    # a failed rank leaves the group as it is: its peers may be inside a
    # collective, and the parent stops them all
    if dist.is_initialized() and "error" not in result:
        dist.destroy_process_group()


def run_ranks(world, fn, *args, backend=None, device="cpu", tmp_dir=None,
              timeout=240.0, threads=None, collective_timeout=None):
    """`fn(rank, world, *args)` on `world` spawned ranks of one group.

    `device` is every rank's device, or a list of one device a rank;
    `backend` defaults to init_distributed's choice for it (NCCL on a
    card, gloo on the CPU).  The store and the results go to a fresh
    directory under `tmp_dir` (default: a temporary directory, removed
    after).  `timeout` bounds the whole run in seconds,
    `collective_timeout` each collective's wait; `threads` sets each
    rank's intra-op threads.  Returns the ranks' results in rank order;
    raises TimeoutError past `timeout` and AssertionError, with the
    traceback, when a rank fails (the other ranks are stopped then)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(
            prefix=f"ranks_{fn.__name__}_{world}_", dir=tmp_dir) as out_dir:
        ctx = mp.start_processes(
            _rank_entry, args=(world, out_dir, fn, args, backend, device,
                               threads, collective_timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1):
                if any(n.endswith(".failed") for n in os.listdir(out_dir)):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks "
                                       f"took over {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        # the first rank to fail is the cause: its peers then fail in
        # their collectives (or were stopped mid-way)
        failed = sorted((os.stat(os.path.join(out_dir, n)).st_mtime_ns,
                         int(n[4:-7])) for n in os.listdir(out_dir)
                        if n.endswith(".failed"))
        if failed:
            rank = failed[0][1]
            error = torch.load(os.path.join(out_dir, f"rank{rank}.pt"),
                               weights_only=False)["error"]
            raise AssertionError(f"rank {rank} of {world} failed first (of "
                                 f"ranks {sorted(r for _, r in failed)}):\n"
                                 f"{error}")
        results = []
        for rank in range(world):
            path = os.path.join(out_dir, f"rank{rank}.pt")
            results.append(torch.load(path, weights_only=False)
                           if os.path.exists(path) else None)
    if None in results:
        raise AssertionError(f"{fn.__name__}: rank {results.index(None)} "
                             f"of {world} ended without a result")
    return [res["ok"] for res in results]
