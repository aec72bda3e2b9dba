"""PPG -> mel (Tacotron2) trainer (the port of
fac_via_ppg_tpu/scripts/train_ppg2mel.py; reference
src/script/train_ppg2mel.py:180-305), on one device.

As the reference: the hparams written to output_dir/hparams.txt, the
datasets featurized up front, resume or warm start from a checkpoint
(epoch_offset from the iteration), per-iteration loss / grad-norm /
duration lines, validation and a checkpoint every `iters_per_checkpoint`.
Also as the JAX package: `checkpoint_path='auto'` (the newest checkpoint
of the run), length-bucketed batches (`length_bucket_size`), LR
schedules, `train_dtype` bfloat16, `grad_accum_steps`, `remat`, async
checkpoint saves, a final checkpoint on SIGTERM, the next batch collated
and copied to the device while a step runs.

Each iteration's dropout masks come from a generator seeded with (seed,
iteration), and a resumed run takes up the epoch's shuffle where it
stood, so resuming at an epoch boundary continues the run as if it had
not stopped.  `compilation_cache_dir` is where the compiled libraries
live (utils/compilation_cache.py).

Data parallelism is one process per GPU (parallel/mesh.py):
`data_parallel_devices` must equal the job's process count (it defaults
to it); each rank reads its shard of every epoch (`EpochBatcher`,
`batch_size` per rank), the step averages the gradients and takes batch
norm over the global batch (train/step.py), `zero_sharded_opt_state`
shards the Adam moments (ZeRO-1, train/optim.py), and only rank 0 logs,
validates and writes checkpoints.  `tensor_parallel_devices` > 1 makes
the job's processes a (data x model) grid (`data_parallel_devices` then
defaults to the process count over it): each rank holds its slices of
the big matrices and conv stacks under the JAX package's rules
(parallel/sharding.py::tacotron2_param_shardings), the step runs them
through the model group's collectives, ZeRO-1 composes, and validation
and checkpoints take the params gathered whole; `train()` returns them
whole.

    python -m fac_via_ppg_torch.scripts.train_ppg2mel key=value ...
    torchrun --nproc_per_node N -m fac_via_ppg_torch.scripts.train_ppg2mel \\
        key=value ...
    torchrun --nproc_per_node 4 -m fac_via_ppg_torch.scripts.train_ppg2mel \\
        tensor_parallel_devices=2 key=value ...    # 2 data x 2 model

(options are create_hparams' keys, plus `device`; the card by default,
cuda:LOCAL_RANK in a launched job).
"""

from __future__ import annotations

import math
import os
import time
from pprint import pprint

import torch
import torch.distributed as dist

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, create_hparams
from fac_via_ppg_torch.data.ppg_mel_dataset import (
    EpochBatcher,
    PPGMelDataset,
    ppg_acoustics_collate,
    ppg_mel_lengths,
)
from fac_via_ppg_torch.data.prefetch import prefetch, to_device
from fac_via_ppg_torch.models.tacotron2 import init_tacotron2
from fac_via_ppg_torch.parallel.mesh import (
    all_stop,
    job_device,
    make_mesh,
    replicate,
)
from fac_via_ppg_torch.parallel.sharding import tacotron2_param_shardings
from fac_via_ppg_torch.parallel.tp import TensorParallel
from fac_via_ppg_torch.train import checkpoint as ckpt
from fac_via_ppg_torch.train import preemption
from fac_via_ppg_torch.train.logger import Tacotron2Logger
from fac_via_ppg_torch.train.optim import (
    make_lr_schedule,
    make_optimizer,
    set_learning_rate,
)
from fac_via_ppg_torch.train.profiling import trace
from fac_via_ppg_torch.train.step import (
    make_tacotron2_eval_step,
    make_tacotron2_train_step,
)
from fac_via_ppg_torch.utils.compilation_cache import enable_compilation_cache
from fac_via_ppg_torch.weights import move


def training_mesh(data_parallel_devices, tensor_parallel_devices, device):
    """The trainers' mesh (JAX train_ppg2mel.py:120-165): the job's
    processes as `data_parallel_devices` x `tensor_parallel_devices`.
    `data_parallel_devices` ("" or None) defaults to the process count
    over the model axis; the product must be the process count, or it
    raises, saying how to launch."""
    n_model = int(tensor_parallel_devices or 1)
    n_data = (int(data_parallel_devices)
              if data_parallel_devices not in ("", None) else None)
    return make_mesh(n_data, n_model, device)


def step_generator(device, seed: int, iteration: int) -> torch.Generator:
    """The generator of one iteration's dropout masks."""
    return torch.Generator(device).manual_seed(seed * 1_000_003 + iteration)


def prepare_directories_and_logger(output_directory, log_directory,
                                   rank: int = 0):
    """Create the run's directory and its TensorBoard logger on rank 0
    (None on the other ranks, as in the JAX package)."""
    if rank != 0:
        return None
    os.makedirs(output_directory, exist_ok=True)
    return Tacotron2Logger(os.path.join(output_directory, log_directory))


def prepare_dataloaders(hparams, device, mesh=None):
    trainset = PPGMelDataset(hparams.training_files, hparams, device=device)
    hparams.load_feats_from_disk = False
    hparams.is_cache_feats = False
    hparams.feats_cache_path = ""
    valset = PPGMelDataset(hparams.validation_files, hparams,
                           deps=getattr(trainset, "ppg_deps", None),
                           device=device)
    train_loader = EpochBatcher(
        trainset, hparams.batch_size, hparams.seed, ppg_acoustics_collate,
        drop_last=True, pad_to=hparams.length_bucket_size,
        shard=mesh.data_rank if mesh is not None else 0,
        num_shards=mesh.shape["data"] if mesh is not None else 1,
        length_fn=ppg_mel_lengths)
    return train_loader, valset


def validate(eval_step, params, model_state, valset, iteration, batch_size,
             logger, pad_to, device):
    """The validation loss, in f32 whatever the training dtype."""
    loader = EpochBatcher(valset, batch_size, 0, ppg_acoustics_collate,
                          drop_last=False, pad_to=pad_to)
    place = to_device(device)
    generator = torch.Generator(device).manual_seed(iteration)
    val_loss, n, last = 0.0, 0, None
    for batch in loader:
        batch = place(batch)
        loss, out = eval_step(params, model_state, batch, generator)
        val_loss += float(loss)
        n += 1
        last = ((batch[2], batch[3]), out)
    val_loss /= max(n, 1)
    if last is not None:
        print("Validation loss {}: {:9f}  ".format(iteration, val_loss))
        logger.log_validation(val_loss, params, *last, iteration)
    return val_loss


def train(output_directory, log_directory, checkpoint_path, warm_start,
          n_gpus, rank, group_name, hparams, device=None):
    """The training loop's entry (the reference train()'s signature, plus
    `device`, the card by default).  Returns (params, model_state,
    opt_state, iteration), the params whole.  The process's rank comes
    from its process group (parallel/mesh.py), not from `rank`."""
    del n_gpus, rank, group_name
    device = job_device(device)
    mesh = training_mesh(hparams.data_parallel_devices,
                         hparams.tensor_parallel_devices, device)
    enable_compilation_cache(hparams.compilation_cache_dir or None)
    cfg = Tacotron2Config.from_hparams(hparams)
    params, model_state = init_tacotron2(
        cfg, torch.Generator().manual_seed(hparams.seed))
    tp = None
    if mesh.shape["model"] > 1:
        tp = TensorParallel(mesh, tacotron2_param_shardings(mesh, params))
    learning_rate = hparams.learning_rate
    optimizer = make_optimizer(learning_rate, hparams.weight_decay,
                               hparams.grad_clip_thresh)
    compute_dtype = (None if hparams.train_dtype == "float32"
                     else getattr(torch, hparams.train_dtype))
    train_step = make_tacotron2_train_step(
        cfg, optimizer, hparams.mel_weight, hparams.gate_weight,
        compute_dtype=compute_dtype, grad_accum=hparams.grad_accum_steps,
        remat=bool(hparams.remat), mesh=mesh, tp=tp)
    eval_step = make_tacotron2_eval_step(cfg, hparams.mel_weight,
                                         hparams.gate_weight)

    logger = prepare_directories_and_logger(output_directory, log_directory,
                                            mesh.rank)
    train_loader, valset = prepare_dataloaders(hparams, device, mesh)
    pad_to = hparams.length_bucket_size

    iteration, epoch_offset, restored = 0, 0, None
    if checkpoint_path == "auto":
        # crash recovery: the newest checkpoint of the run directory
        checkpoint_path = ckpt.find_latest_checkpoint(output_directory)
        if checkpoint_path:
            print("Auto-resume from", checkpoint_path)
    if checkpoint_path:
        if warm_start:
            print("Warm starting model from checkpoint '%s'"
                  % checkpoint_path)
            params = ckpt.warm_start(checkpoint_path)
        else:
            restored = ckpt.load_checkpoint(checkpoint_path)
            params = restored["params"]
            model_state = restored.get("model_state", model_state)
            if hparams.use_saved_learning_rate:
                learning_rate = restored["learning_rate"]
            iteration = restored["iteration"] + 1
            epoch_offset = max(0, int(iteration / len(train_loader)))
            print("Loaded checkpoint '%s' from iteration %d"
                  % (checkpoint_path, iteration - 1))
    params, model_state = move(params, device), move(model_state, device)
    # every rank starts from rank 0's values (JAX `replicate`), then
    # keeps its slices under tensor parallelism
    replicate(mesh, (params, model_state))
    if tp is not None:
        params = tp.shard(params)
    opt_state = optimizer.init(params, mesh=mesh,
                               zero=bool(hparams.zero_sharded_opt_state),
                               tp=tp)
    if restored is not None:
        opt_state.load_state_dict(restored["opt_state"])
    train_loader.epoch = epoch_offset

    # The bf16 step's first op casts the PPG to bf16; casting it on the
    # host instead is the same rounding and halves the dominant copy.
    place = to_device(device, {0: torch.bfloat16}
                      if compute_dtype == torch.bfloat16 else None)
    with trace(hparams.profile_dir):
        params, model_state, opt_state, iteration = _train_loop(
            hparams, params, model_state, opt_state, train_step, eval_step,
            train_loader, valset, logger, learning_rate, iteration,
            epoch_offset, output_directory, pad_to, place, device, mesh, tp)
    if tp is not None:
        params = tp.gather(params)
    return params, model_state, opt_state, iteration


def _train_loop(hparams, params, model_state, opt_state, train_step,
                eval_step, train_loader, valset, logger, learning_rate,
                iteration, epoch_offset, output_directory, pad_to, place,
                device, mesh, tp):
    saver = ckpt.AsyncCheckpointSaver(mesh, tp)
    try:
        with preemption.PreemptionGuard() as guard:
            result = _epoch_loop(
                hparams, params, model_state, opt_state, train_step,
                eval_step, train_loader, valset, logger, learning_rate,
                iteration, epoch_offset, output_directory, pad_to, place,
                device, saver, guard, mesh, tp)
    except BaseException:
        # land an announced checkpoint even on a crash or an interrupt
        # ('auto' recovery depends on it), without masking the error
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
    return result


def _epoch_loop(hparams, params, model_state, opt_state, train_step,
                eval_step, train_loader, valset, logger, learning_rate,
                iteration, epoch_offset, output_directory, pad_to, place,
                device, saver, guard, mesh, tp):
    # `learning_rate` stays the base rate, which checkpoints store; the
    # schedule recomputes each iteration's rate from it
    lr_schedule = make_lr_schedule(
        learning_rate, schedule=hparams.lr_schedule,
        warmup_steps=hparams.lr_warmup_steps,
        decay_steps=hparams.lr_decay_steps,
        decay_rate=hparams.lr_decay_rate, min_factor=hparams.lr_min_factor)

    lead = mesh.rank == 0

    def save(it, what):
        path = os.path.join(output_directory, "checkpoint_{}".format(it))
        if lead:
            print("{} at iteration {} to {}".format(what, it, path))
        saver.save(path, params, opt_state, learning_rate, it, model_state)

    for epoch in range(epoch_offset, hparams.epochs):
        if lead:
            print("Epoch: {}".format(epoch))
        for batch in prefetch(train_loader, place, depth=2):
            start = time.perf_counter()
            current_lr = lr_schedule(iteration)
            set_learning_rate(opt_state, current_lr)
            out = train_step(params, model_state, opt_state, batch,
                             step_generator(device, hparams.seed,
                                            iteration))
            model_state = out.model_state
            reduced_loss = float(out.loss)
            grad_norm = float(out.grad_norm)
            if not math.isnan(reduced_loss) and lead:
                duration = time.perf_counter() - start
                print("Train loss {} {:.6f} Grad Norm {:.6f} {:.2f}s/it"
                      .format(iteration, reduced_loss, grad_norm, duration))
                logger.log_training(reduced_loss, grad_norm, current_lr,
                                    duration, iteration)
            if iteration % hparams.iters_per_checkpoint == 0:
                # every rank gathers (a collective), rank 0 validates
                whole = params if tp is None else tp.gather(params)
                if lead:
                    validate(eval_step, whole, model_state, valset,
                             iteration, hparams.batch_size, logger, pad_to,
                             device)
                save(iteration, "Saving model and optimizer state")
            iteration += 1
            if all_stop(guard.should_stop(), mesh):
                last = iteration - 1
                if last % hparams.iters_per_checkpoint != 0:
                    save(last, "Preemption: saving final checkpoint")
                if lead:
                    print("Preemption: exiting cleanly after iteration",
                          last)
                return params, model_state, opt_state, iteration
    return params, model_state, opt_state, iteration


def main(device=None, **kwargs):
    hparams = create_hparams(**kwargs)
    if not hparams.output_directory:
        raise FileExistsError("Please specify the output dir.")
    device = job_device(device)
    os.makedirs(hparams.output_directory, exist_ok=True)
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(os.path.join(hparams.output_directory, "hparams.txt"),
                  "w") as writer:
            pprint(hparams.__dict__, writer)
    print("Device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else device)
    return train(hparams.output_directory, hparams.log_directory,
                 hparams.checkpoint_path, hparams.warm_start, hparams.n_gpus,
                 hparams.rank, hparams.group_name, hparams, device=device)


def parse_overrides(args) -> dict:
    """`key=value` arguments -> a dict, values read as Python literals
    where they parse as one."""
    import ast

    overrides = {}
    for arg in args:
        k, _, v = arg.partition("=")
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return overrides


if __name__ == "__main__":
    import sys

    main(**parse_overrides(sys.argv[1:]))
