"""Multi-process training launcher.

The port of fac_via_ppg_tpu/scripts/multiproc.py.  The reference spawns
one training process per GPU rendezvousing over a NCCL TCP URL
(src/common/multiproc.py:38-55, src/waveglow/distributed.py:145-170);
the port runs one process per GPU too (parallel/mesh.py).  This launcher
keeps the JAX package's flags, which become a `tcp://` rendezvous, and
runs one process; start one per GPU:

  python -m fac_via_ppg_torch.scripts.multiproc \\
      --coordinator HOST:PORT --num_processes N --process_id I \\
      train_ppg2mel output_directory=... training_files=...

With no flags it reads torchrun's environment, so torchrun starts them
all:

  torchrun --nproc_per_node N -m fac_via_ppg_torch.scripts.multiproc \\
      train_waveglow config=config.json output_directory=...

Each process takes cuda:LOCAL_RANK (LOCAL_RANK from the environment,
else the process id) and the NCCL backend, or with `device=cpu` as an
override the CPU and gloo.  Without flags or environment, one process
trains alone.
"""

from __future__ import annotations

import argparse
import os

from fac_via_ppg_torch.parallel.mesh import init_distributed
from fac_via_ppg_torch.scripts.train_ppg2mel import parse_overrides


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, device=None):
    """Join (or form) the job's process group from the JAX flags
    (`coordinator` HOST:PORT, `num_processes`, `process_id`), or from
    torchrun's environment when they are absent; returns this process's
    device (parallel/mesh.py::init_distributed, which picks the backend
    for it)."""
    init_method = None
    if coordinator or num_processes:
        if not (coordinator and num_processes and process_id is not None):
            raise ValueError("--coordinator, --num_processes and "
                             "--process_id go together")
        init_method = f"tcp://{coordinator}"
        # the process's card, unless a launcher named it
        os.environ.setdefault("LOCAL_RANK", str(process_id))
    return init_distributed(init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rendezvous address HOST:PORT (process 0's "
                             "host); absent: torchrun's environment")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("trainer", choices=["train_ppg2mel",
                                            "train_waveglow"])
    parser.add_argument("overrides", nargs="*",
                        help="key=value options of the trainer "
                             "(config=PATH names train_waveglow's JSON)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    overrides = parse_overrides(args.overrides)
    device = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        overrides.pop("device", None))
    if args.trainer == "train_ppg2mel":
        from fac_via_ppg_torch.scripts.train_ppg2mel import main as train

        return train(device=device, **overrides)
    from fac_via_ppg_torch.scripts.train_waveglow import main as train

    config = overrides.pop("config", None)
    if config:
        return train(config, device=device, **overrides)
    return train(device=device, **overrides)


if __name__ == "__main__":
    main()
