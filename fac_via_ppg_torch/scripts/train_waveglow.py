"""WaveGlow trainer (the port of fac_via_ppg_tpu/scripts/train_waveglow.py;
reference src/script/train_waveglow.py:66-188), on one device.

As the reference: the 4-section JSON config (train / data / dist /
waveglow) snapshotted into the output directory, per-iteration loss lines
and a checkpoint every `iters_per_checkpoint`; as the JAX package:
`checkpoint_path='auto'`, LR schedules, `train_dtype` bfloat16,
`grad_accum_steps`, `remat`, async saves, a final checkpoint on SIGTERM.
The WN convs train in their weight-norm form on the conv formulation
(models/waveglow.py::waveglow_forward); checkpoints hold that form.

    python -m fac_via_ppg_torch.scripts.train_waveglow [-c config.json] \\
        [key=value ...]

(overrides of train_config / data_config keys, plus `device`; the card by
default).  `compilation_cache_dir` is where the compiled libraries live
(utils/compilation_cache.py).

Data parallelism and ZeRO-1 as the PPG trainer's (scripts/
train_ppg2mel.py): one process per GPU, `data_parallel_devices` the
process count, each rank's shard of the crops (`batch_size` per rank),
gradients averaged, only rank 0 logs and writes checkpoints; launch with
torchrun or scripts/multiproc.py.  `tensor_parallel_devices` > 1 makes
the processes a (data x model) grid: each rank holds its WN channels under
the paired rule (parallel/sharding.py::waveglow_param_shardings, on the
weight-norm train form), ZeRO-1 composes, checkpoints hold the params
gathered whole and `train()` returns them whole.

    torchrun --nproc_per_node 4 -m fac_via_ppg_torch.scripts.train_waveglow \\
        -c config.json tensor_parallel_devices=2     # 2 data x 2 model
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.data.mel2samp import Mel2Samp, mel2samp_collate
from fac_via_ppg_torch.data.ppg_mel_dataset import EpochBatcher
from fac_via_ppg_torch.data.prefetch import prefetch, to_device
from fac_via_ppg_torch.models.waveglow import init_waveglow, \
    weight_norm_params
from fac_via_ppg_torch.parallel.mesh import all_stop, job_device, replicate
from fac_via_ppg_torch.parallel.sharding import waveglow_param_shardings
from fac_via_ppg_torch.parallel.tp import TensorParallel
from fac_via_ppg_torch.scripts.train_ppg2mel import (
    parse_overrides,
    training_mesh,
)
from fac_via_ppg_torch.train import checkpoint as ckpt
from fac_via_ppg_torch.train import preemption
from fac_via_ppg_torch.train.logger import WaveglowLogger
from fac_via_ppg_torch.train.optim import (
    make_lr_schedule,
    make_optimizer,
    set_learning_rate,
)
from fac_via_ppg_torch.train.step import make_waveglow_train_step
from fac_via_ppg_torch.utils.compilation_cache import enable_compilation_cache
from fac_via_ppg_torch.weights import move


def train(num_gpus, rank, group_name, output_directory, epochs,
          learning_rate, sigma, iters_per_checkpoint, batch_size, seed,
          checkpoint_path, data_config=None, waveglow_config=None,
          train_dtype="float32", grad_accum_steps=1, lr_schedule="constant",
          lr_warmup_steps=0, lr_decay_steps=0, lr_decay_rate=1.0,
          lr_min_factor=0.0, tensor_parallel_devices=1,
          data_parallel_devices=None, zero_sharded_opt_state=False,
          remat=False, compilation_cache_dir="", device=None):
    """The reference train()'s signature (train_waveglow.py:66), the JAX
    package's extensions, and `device` (the card by default).  Returns
    (params, opt_state, iteration), the params whole.  The process's rank
    comes from its process group (parallel/mesh.py), not from `rank`."""
    del num_gpus, rank, group_name
    device = job_device(device)
    mesh = training_mesh(data_parallel_devices, tensor_parallel_devices,
                         device)
    enable_compilation_cache(compilation_cache_dir or None)
    cfg = WaveGlowConfig.from_dict(waveglow_config or {})
    params = weight_norm_params(
        init_waveglow(cfg, torch.Generator().manual_seed(seed)))
    tp = None
    if mesh.shape["model"] > 1:
        tp = TensorParallel(mesh, waveglow_param_shardings(mesh, params))
    optimizer = make_optimizer(learning_rate)
    step = make_waveglow_train_step(
        cfg, optimizer, sigma=sigma,
        compute_dtype=(None if train_dtype == "float32"
                       else getattr(torch, train_dtype)),
        grad_accum=grad_accum_steps, remat=remat, mesh=mesh, tp=tp)

    iteration, restored = 0, None
    if checkpoint_path == "auto":
        checkpoint_path = ckpt.find_latest_checkpoint(output_directory,
                                                      prefix="waveglow_")
        if checkpoint_path:
            print("Auto-resume from", checkpoint_path)
    if checkpoint_path:
        restored = ckpt.load_checkpoint(checkpoint_path)
        params = restored["params"]
        iteration = restored["iteration"] + 1
        print("Loaded checkpoint '{}' (iteration {})".format(
            checkpoint_path, restored["iteration"]))
    params = move(params, device)
    # every rank starts from rank 0's values (JAX `replicate`), then
    # keeps its slices under tensor parallelism
    replicate(mesh, params)
    if tp is not None:
        params = tp.shard(params)
    opt_state = optimizer.init(params, mesh=mesh,
                               zero=bool(zero_sharded_opt_state), tp=tp)
    if restored is not None:
        opt_state.load_state_dict(restored["opt_state"])

    trainset = Mel2Samp(**data_config)
    train_loader = EpochBatcher(trainset, batch_size, seed, mel2samp_collate,
                                drop_last=True, shard=mesh.data_rank,
                                num_shards=mesh.shape["data"])
    log_dir = os.path.join(output_directory, "log")
    logger = None
    if mesh.rank == 0:
        os.makedirs(log_dir, exist_ok=True)
        print("output directory", output_directory)
        print("log directory", log_dir)
        logger = WaveglowLogger(log_dir)
    epoch_offset = max(0, int(iteration / max(len(train_loader), 1)))
    train_loader.epoch = epoch_offset
    schedule = make_lr_schedule(
        learning_rate, schedule=lr_schedule, warmup_steps=lr_warmup_steps,
        decay_steps=lr_decay_steps, decay_rate=lr_decay_rate,
        min_factor=lr_min_factor)
    saver = ckpt.AsyncCheckpointSaver(mesh, tp)
    try:
        with preemption.PreemptionGuard() as guard:
            result = _waveglow_epoch_loop(
                epochs, epoch_offset, train_loader, to_device(device), step,
                params, opt_state, learning_rate, schedule,
                iters_per_checkpoint, output_directory, logger, saver,
                iteration, guard, mesh)
    except BaseException:
        # land an announced checkpoint even on a crash or an interrupt
        try:
            saver.wait()
        except BaseException as save_err:
            print(f"WARNING: final async checkpoint save failed: "
                  f"{save_err!r}")
        raise
    finally:
        if logger is not None:
            logger.close()
    saver.wait()
    params, opt_state, iteration = result
    if tp is not None:
        params = tp.gather(params)
    return params, opt_state, iteration


def _waveglow_epoch_loop(epochs, epoch_offset, train_loader, place, step,
                         params, opt_state, base_lr, lr_schedule,
                         iters_per_checkpoint, output_directory, logger,
                         saver, iteration, guard, mesh):
    """Checkpoints store `base_lr`, not the scheduled rate: resume
    rebuilds the schedule from the base and the restored iteration."""
    lead = mesh.rank == 0

    def save(it, what):
        path = "{}/waveglow_{}".format(output_directory, it)
        if lead:
            print("{} at iteration {} to {}".format(what, it, path))
        saver.save(path, params, opt_state, base_lr, it)

    for epoch in range(epoch_offset, epochs):
        if lead:
            print("Epoch: {}".format(epoch))
        for batch in prefetch(train_loader, place, depth=2):
            start = time.perf_counter()
            set_learning_rate(opt_state, lr_schedule(iteration))
            out = step(params, opt_state, batch)
            reduced_loss = float(out.loss)
            duration = time.perf_counter() - start
            if lead:
                print("{}:\t{:.9f}\t({:.2f}s/it)".format(
                    iteration, reduced_loss, duration))
                logger.log_training(reduced_loss, iteration)
            if iteration % iters_per_checkpoint == 0:
                save(iteration, "Saving model and optimizer state")
            iteration += 1
            if all_stop(guard.should_stop(), mesh):
                last = iteration - 1
                if last % iters_per_checkpoint != 0:
                    save(last, "Preemption: saving final checkpoint")
                if lead:
                    print("Preemption: exiting cleanly after iteration",
                          last)
                return params, opt_state, iteration
    return params, opt_state, iteration


def main(config_file_path: str = DEFAULT_WAVEGLOW_CONFIG_PATH, device=None,
         **overrides):
    with open(config_file_path) as f:
        config = json.load(f)
    train_config = dict(config["train_config"])
    # the parallel options and the compilation cache are override-only
    # keys (absent from the reference's config.json sections)
    extra_keys = ("tensor_parallel_devices", "data_parallel_devices",
                  "zero_sharded_opt_state", "compilation_cache_dir")
    train_config.update({k: v for k, v in overrides.items()
                         if k in train_config or k in extra_keys})
    data_config = dict(config["data_config"])
    data_config.update({k: v for k, v in overrides.items()
                        if k in data_config})
    dist_config = config.get("dist_config", {})
    device = job_device(device)
    os.makedirs(train_config["output_directory"], exist_ok=True)
    # snapshot the config (reference train_waveglow.py:163-166), rank 0
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(os.path.join(train_config["output_directory"],
                               "config.json"), "w") as writer:
            json.dump(config, writer)
    print("Device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device)
    return train(1, dist_config.get("rank", 0),
                 dist_config.get("group_name", ""), **train_config,
                 data_config=data_config,
                 waveglow_config=config["waveglow_config"], device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str,
                        default=DEFAULT_WAVEGLOW_CONFIG_PATH,
                        help="JSON file for configuration")
    parser.add_argument("overrides", nargs="*",
                        help="key=value overrides for train/data config, "
                        "or device=cpu")
    args = parser.parse_args()
    main(args.config, **parse_overrides(args.overrides))
