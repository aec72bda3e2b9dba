"""Driver entry points, the port of the root `__graft_entry__.py`.

entry()                 -> (fn, example_args): the full-width Tacotron2
                           teacher-forced forward in eval mode on a seeded
                           example batch.
dryrun_multichip(n)     -> n spawned ranks of one process group
                           (parallel/spawn.py), one card each (NCCL), or n
                           gloo ranks on the CPU with device="cpu", run the
                           JAX function's tagged checks and print one line
                           each:
    [tacotron2]          a DP x TP train step at full Tacotron2 widths
                         (tiny batch, remat), the model axis 2 at n = 4
                         or 8, 4 at 16, 8 at 32;
    [tacotron2-2x4]      the model-heavy (2 data x 4 model) step, n >= 8;
    [waveglow]           a WaveGlow step data parallel over all n, ZeRO-1;
    [waveglow-tp-zero1]  the same step DP x TP, the Adam moments composing
                         both mesh axes, its loss the DP step's;
    [ckpt-topology]      a checkpoint written under that TP + ZeRO-1 mesh
                         resumed at (n x 1) + ZeRO-1 and in one process,
                         the next loss the source mesh's;
    [serving]            the batched decode and the vocoder, the batch
                         split over the data axis;
    [serving-pipelined]  FusedSynthesizer(data_parallel=True) with two
                         micro-batches in flight (WaveGlow at 128 WN
                         channels: the layer kernel's least width).

    python -m fac_via_ppg_torch.graft_entry [N] [--cpu]

Nothing falls back from the card to the CPU: `device=None` raises on a
machine with fewer than n cards.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch


def _example_batch(cfg, B=2, T_in=24, T_out=32, seed=0):
    """The JAX entry's example batch (`__graft_entry__._example_batch`),
    from the same seeded numpy draws."""
    rng = np.random.RandomState(seed)
    ppg = np.abs(rng.rand(B, cfg.n_symbols, T_in)).astype(np.float32)
    ppg /= ppg.sum(axis=1, keepdims=True)
    in_len = (T_in - rng.randint(0, max(T_in // 4, 1), size=B)).astype(
        np.int64)
    in_len[0] = T_in
    mel = (rng.randn(B, cfg.n_acoustic_feat_dims, T_out) * 0.1).astype(
        np.float32)
    out_len = (T_out - rng.randint(0, max(T_out // 4, 1), size=B)).astype(
        np.int64)
    out_len[0] = T_out
    gate = (np.arange(T_out)[None, :] >= (out_len - 1)[:, None]).astype(
        np.float32)
    return ppg, in_len, mel, gate, out_len


def entry(device=None):
    """(fn, example_args): fn(params, state, ppg, in_len, mel, out_len,
    generator, masks=None) -> (mel_post, gate_out, alignments), the
    full-width Tacotron2's teacher-forced forward in eval mode (the
    prenet's dropout stays on: its keep-masks from `generator`, or
    injected through `masks` in call order).  The params are seeded;
    `device` places them and the batch (None: the card)."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.models.tacotron2 import (
        init_tacotron2,
        tacotron2_forward,
    )
    from fac_via_ppg_torch.utils.device import resolve_device
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    cfg = Tacotron2Config()
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(0))
    ppg, in_len, mel, _, out_len = _example_batch(cfg)

    def fn(params, state, ppg, in_len, mel, out_len, generator, masks=None):
        with torch.no_grad():
            (_, mel_post, gate_out, align), _ = tacotron2_forward(
                cfg, params, state, ppg, in_len, mel, out_len,
                generator=generator,
                masks=None if masks is None else iter(masks),
                training=False)
        return mel_post, gate_out, align

    args = (move(params, dev), move(state, dev),
            *(torch.as_tensor(x, device=dev)
              for x in (ppg, in_len, mel, out_len)),
            torch.Generator(dev).manual_seed(0))
    return fn, args


def model_axis_for(n: int) -> int:
    """The JAX dryrun's model axis (`__graft_entry__.py:107-117`): 2 at
    n = 4 or 8, 4 at 16, 8 at 32, 1 for odd n."""
    if n % 2 or n < 2:
        return 1
    m = max(2, min(8, n // 4))
    while n % m:
        m //= 2
    return m


def _tacotron2_tp_step(cfg, mesh, seed, B, generator_seed):
    """One full-width Tacotron2 train step (remat) on `mesh`: this rank's
    slices of the seeded params under the JAX rules, its rows of the
    example batch.  Returns (loss, grad_norm)."""
    from fac_via_ppg_torch.models.tacotron2 import init_tacotron2
    from fac_via_ppg_torch.parallel.mesh import shard_batch
    from fac_via_ppg_torch.parallel.sharding import tacotron2_param_shardings
    from fac_via_ppg_torch.parallel.tp import TensorParallel
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import make_tacotron2_train_step
    from fac_via_ppg_torch.weights import move

    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(seed))
    params, state = move(params, mesh.device), move(state, mesh.device)
    tp = TensorParallel(mesh, tacotron2_param_shardings(mesh, params))
    params = tp.shard(params)
    opt = make_optimizer(1e-4, 1e-6, 1.0)
    opt_state = opt.init(params, mesh=mesh, tp=tp)
    step = make_tacotron2_train_step(cfg, opt, remat=True, mesh=mesh, tp=tp)
    batch = tuple(torch.as_tensor(x, device=mesh.device) for x in
                  shard_batch(mesh, _example_batch(cfg, B=B, T_in=16,
                                                   T_out=20)))
    out = step(params, state, opt_state, batch,
               torch.Generator(mesh.device).manual_seed(generator_seed))
    return float(out.loss), float(out.grad_norm)


def _wg_cfg():
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig

    return WaveGlowConfig(
        n_mel_channels=16, hop_length=32, n_flows=4, n_group=8,
        n_early_every=2, n_early_size=2, wn_n_layers=2, wn_n_channels=32,
        wn_kernel_size=3, upsample_kernel_size=64)


def _wg_step(cfg, mesh, params, batch, zero=True, tp=None):
    """One WaveGlow step (Adam 1e-4) on this rank's rows, ZeRO-1 over the
    data axis, tensor parallel under `tp` (`params` this rank's slices):
    (loss, the optimizer state, the step, this rank's rows on its
    device)."""
    from fac_via_ppg_torch.parallel.mesh import shard_batch
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import make_waveglow_train_step

    opt = make_optimizer(1e-4)
    opt_state = opt.init(params, mesh=mesh, zero=zero, tp=tp)
    step = make_waveglow_train_step(cfg, opt, sigma=0.7071, mesh=mesh, tp=tp)
    rows = tuple(torch.as_tensor(x, device=mesh.device)
                 for x in shard_batch(mesh, batch))
    loss = float(step(params, opt_state, rows).loss)
    return loss, opt_state, step, rows


def _rank_dryrun(rank, world, model_axis, tmp, devices):
    """The tagged checks on one rank (on `devices`, or `devices[rank]`);
    returns the lines (rank 0 prints them)."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        weight_norm_params,
    )
    from fac_via_ppg_torch.parallel.mesh import make_mesh
    from fac_via_ppg_torch.parallel.sharding import waveglow_param_shardings
    from fac_via_ppg_torch.parallel.tp import TensorParallel
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import make_waveglow_train_step
    from fac_via_ppg_torch.utils.tree import tree_map
    from fac_via_ppg_torch.weights import move

    lines = []
    dev = devices[rank] if isinstance(devices, list) else devices
    data_axis = world // model_axis
    mesh = make_mesh(data=data_axis, model=model_axis, device=dev)
    dev = mesh.device
    cfg = Tacotron2Config()
    loss, gnorm = _tacotron2_tp_step(cfg, mesh, 0, max(2, 2 * data_axis), 1)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert np.isfinite(gnorm), f"non-finite grad norm {gnorm}"
    lines.append(f"dryrun_multichip[tacotron2]: mesh=({data_axis} data x "
                 f"{model_axis} model) loss={loss:.4f} "
                 f"grad_norm={gnorm:.4f} OK")
    if world >= 8 and world % 4 == 0:
        mh = make_mesh(data=2, model=4, device=dev)
        mh_loss, _ = _tacotron2_tp_step(cfg, mh, 7, 4, 8)
        assert np.isfinite(mh_loss), f"non-finite 2x4 loss {mh_loss}"
        lines.append(f"dryrun_multichip[tacotron2-2x4]: mesh=(2 data x 4 "
                     f"model) loss={mh_loss:.4f} OK")

    # WaveGlow, data parallel over the whole job, ZeRO-1
    wg_cfg = _wg_cfg()
    wg_whole = move(weight_norm_params(init_waveglow(
        wg_cfg, torch.Generator().manual_seed(2))), dev)
    rng = np.random.RandomState(0)
    B = 2 * world
    batch = (rng.randn(B, 16, 8).astype(np.float32),
             (rng.randn(B, 8 * 32) * 0.1).astype(np.float32))
    flat = make_mesh(data=world, model=1, device=dev)
    wg_loss, _, _, _ = _wg_step(wg_cfg, flat, tree_map(torch.clone,
                                                       wg_whole), batch)
    assert np.isfinite(wg_loss), f"non-finite waveglow loss {wg_loss}"
    lines.append(f"dryrun_multichip[waveglow]: mesh=({world} data) "
                 f"zero1-opt loss={wg_loss:.4f} OK")

    if model_axis > 1:
        tp = TensorParallel(mesh, waveglow_param_shardings(mesh, wg_whole))
        wg_tp = tp.shard(wg_whole)
        tp_loss, opt_state, step, rows = _wg_step(wg_cfg, mesh, wg_tp, batch,
                                                  tp=tp)
        composed = [s for s in opt_state.specs
                    if "model" in str(s) and "data" in str(s)]
        assert composed, "no moment leaf composes 'model' + 'data'"
        assert np.isfinite(tp_loss), f"non-finite TP waveglow loss {tp_loss}"
        assert abs(tp_loss - wg_loss) < 1e-3 * max(1.0, abs(wg_loss)), (
            f"TP loss {tp_loss} != DP loss {wg_loss}")
        lines.append(f"dryrun_multichip[waveglow-tp-zero1]: mesh=("
                     f"{data_axis} data x {model_axis} model) zero1-composed"
                     f" ({len(composed)} leaves) loss={tp_loss:.4f} OK")

        # the checkpoint of the TP + ZeRO-1 state after that step, then
        # two more steps on the source mesh; the same two steps resumed at
        # (world x 1) + ZeRO-1 and in one process: the second step's loss
        # reads the params that the restored moments updated
        path = f"{tmp}/waveglow_0"
        ckpt.save_checkpoint(path, wg_tp, opt_state, 1e-4, 0, mesh=mesh,
                             tp=tp)
        step(wg_tp, opt_state, rows)
        src_loss = float(step(wg_tp, opt_state, rows).loss)
        opt = make_optimizer(1e-4)

        def resumed(m):
            # read anew: the optimizer updates what it loaded in place
            payload = ckpt.load_checkpoint(path)
            params = move(payload["params"], dev)
            state = opt.init(params, mesh=m, zero=m is not None)
            state.load_state_dict(payload["opt_state"])
            b = batch if m is None else tuple(
                x[m.data_rank * 2:(m.data_rank + 1) * 2] for x in batch)
            b = tuple(torch.as_tensor(x, device=dev) for x in b)
            st = make_waveglow_train_step(wg_cfg, opt, sigma=0.7071, mesh=m)
            st(params, state, b)
            return float(st(params, state, b).loss)

        r_loss = resumed(flat)
        s_loss = resumed(None) if rank == 0 else r_loss
        for name, got in (("topology-change", r_loss),
                          ("single-device", s_loss)):
            assert abs(got - src_loss) <= 1e-5 * abs(src_loss), (
                f"{name} restore loss {got} != source-mesh {src_loss}")
        lines.append(f"dryrun_multichip[ckpt-topology]: ({data_axis}x"
                     f"{model_axis})+zero1 checkpoint -> ({world}x1)+zero1 "
                     f"loss={r_loss:.6f} and (1x1) loss={s_loss:.6f} both "
                     f"== source {src_loss:.6f} OK")

    lines.append(_serving(flat, rng))
    lines.append(_serving_pipelined(flat, tmp, rank))
    return lines


def _tiny_t2(max_decoder_steps=8):
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config

    return Tacotron2Config(
        n_symbols=16, symbols_embedding_dim=16, encoder_embedding_dim=16,
        decoder_rnn_dim=12, prenet_dim=8, attention_rnn_dim=12,
        attention_dim=8, attention_location_n_filters=4,
        attention_location_kernel_size=7, postnet_embedding_dim=16,
        max_decoder_steps=max_decoder_steps)


def _serving(mesh, rng):
    """The batched decode chained into the vocoder, each rank its rows of
    the global batch and of its draws, the audio gathered."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models import tacotron2 as tt
    from fac_via_ppg_torch.models import waveglow as tw
    from fac_via_ppg_torch.parallel.mesh import gather_rows, rank_rows
    from fac_via_ppg_torch.weights import move

    dev = mesh.device
    t2_cfg = _tiny_t2()
    t2_params, t2_state = tt.init_tacotron2(t2_cfg,
                                            torch.Generator().manual_seed(3))
    wg_cfg = WaveGlowConfig(
        n_mel_channels=t2_cfg.n_acoustic_feat_dims, hop_length=32,
        n_flows=2, n_group=8, n_early_every=4, n_early_size=2,
        wn_n_layers=2, wn_n_channels=16, wn_kernel_size=3,
        upsample_kernel_size=64)
    wg_params = move(tw.remove_weightnorm(tw.init_waveglow(
        wg_cfg, torch.Generator().manual_seed(4))), dev)
    t2_params, t2_state = move(t2_params, dev), move(t2_state, dev)
    B = 2 * mesh.shape["data"]
    ppg = np.abs(rng.rand(B, t2_cfg.n_symbols, 12)).astype(np.float32)
    ppg /= ppg.sum(axis=1, keepdims=True)
    rows = rank_rows(mesh, B)
    g = torch.Generator(dev).manual_seed(5)
    masks = [m[rows] for m in tt.inference_masks(t2_cfg, t2_params, B, 12,
                                                 dev, g)]
    with torch.no_grad():
        _, mel_post, _, _, _ = tt.tacotron2_inference_batched(
            t2_cfg, t2_params, t2_state,
            torch.as_tensor(ppg[rows], device=dev),
            torch.full((rows.stop - rows.start,), 12, device=dev),
            masks=iter(masks))
        G = mel_post.shape[2] * wg_cfg.hop_length // wg_cfg.n_group
        noise = [z[rows] for z in tw.waveglow_noise(wg_cfg, B, G, g, dev)]
        audio = tw.waveglow_infer(wg_cfg, wg_params, mel_post, 0.6,
                                  noise=noise, wn_impl="conv")
        audio = gather_rows(mesh, audio.float(), B).cpu().numpy()
    assert audio.shape[0] == B
    assert np.isfinite(audio).all(), "non-finite served audio"
    return (f"dryrun_multichip[serving]: mesh=({mesh.shape['data']} data) "
            f"batch={B} samples={audio.shape[1]} OK")


def _serving_pipelined(mesh, tmp, rank):
    """FusedSynthesizer data parallel over `mesh`, two micro-batches in
    flight (the streaming converter's pipeline_depth=2 pattern)."""
    from scipy.io import wavfile

    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.eval.fused import FusedSynthesizer
    from fac_via_ppg_torch.frontend.ppg import DependenciesPPG
    from fac_via_ppg_torch.models import tacotron2 as tt
    from fac_via_ppg_torch.models import waveglow as tw
    from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle

    root = f"{tmp}/rank{rank}"
    make_bundle(f"{root}/bundle", n_senones=16, n_phones=4, hidden_dim=8,
                num_layers=1)
    deps = DependenciesPPG(
        nnet_path=f"{root}/bundle/am/final.raw.txt",
        lda_path=f"{root}/bundle/feats/final.mat",
        reduce_dim_path=f"{root}/bundle/feats/reduce_dim.mat",
        splice_opts_path=f"{root}/bundle/feats/splice_opts")
    cfg = _tiny_t2()
    t2_params, t2_state = tt.init_tacotron2(cfg,
                                            torch.Generator().manual_seed(9))
    # 128 WN channels, not the JAX check's 16: on a card the synthesizer
    # serves on the WN layer kernel, which takes multiples of 128
    wg_cfg = WaveGlowConfig(
        n_mel_channels=cfg.n_acoustic_feat_dims, hop_length=160,
        n_flows=2, n_group=8, n_early_every=4, n_early_size=2,
        wn_n_layers=2, wn_n_channels=128, wn_kernel_size=3,
        upsample_kernel_size=1024)
    wg_params = tw.remove_weightnorm(tw.init_waveglow(
        wg_cfg, torch.Generator().manual_seed(10)))
    synth = FusedSynthesizer(cfg, t2_params, t2_state, wg_cfg, wg_params,
                             deps=deps, sigma=0.0, serving_dtype=None,
                             max_frames=8, feat_bucket=16,
                             device=mesh.device, mesh=mesh)
    t = np.arange(4000) / 16000.0
    wavs = []
    for i in range(2 * mesh.shape["data"]):
        p = f"{root}/u{i}.wav"
        wavfile.write(p, 16000, (np.sin(2 * np.pi * (150 + 10 * i) * t)
                                 * 9000).astype(np.int16))
        wavs.append(p)
    pairs = [synth.featurize(p) for p in wavs]
    half = len(pairs) // 2
    g0 = torch.Generator(mesh.device).manual_seed(11)
    g1 = torch.Generator(mesh.device).manual_seed(12)
    # depth 2: batch 1 launched before batch 0 is collected
    h0 = synth.launch_feature_pairs(pairs[:half], g0)
    h1 = synth.launch_feature_pairs(pairs[half:], g1)
    pcm0 = synth.collect_feature_pairs(h0)
    pcm1 = synth.collect_feature_pairs(h1)
    assert len(pcm0) == half and len(pcm1) == len(pairs) - half
    for w in pcm0 + pcm1:
        assert w.dtype == np.int16
        assert np.isfinite(w.astype(np.float64)).all()
    return (f"dryrun_multichip[serving-pipelined]: mesh=("
            f"{mesh.shape['data']} data) 2 micro-batches of {half} in "
            f"flight OK")


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900.0
                     ) -> list:
    """The tagged checks on `n_devices` spawned ranks (see the module
    doc); prints rank 0's lines and returns them.  `device=None`: one
    NCCL rank a card, cuda:0 .. cuda:n-1, raising when the machine has
    fewer; `device="cpu"`: n gloo ranks, the JAX function's own mode (a
    virtual CPU mesh).  Nothing falls back from one to the other."""
    from fac_via_ppg_torch.parallel.spawn import run_ranks

    n = int(n_devices)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, one "
                               f"a rank; this machine has {have} (pass "
                               f"device='cpu' for gloo ranks on the CPU)")
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = str(torch.device(device))
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(n, _rank_dryrun, model_axis_for(n), tmp, devices,
                        device=devices, tmp_dir=tmp, timeout=timeout,
                        threads=1 if device is not None else None)
    for line in res[0]:
        print(line, flush=True)
    return res[0]


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dryrun_multichip(int(args[0]) if args else 8,
                     device="cpu" if "--cpu" in sys.argv else None)
