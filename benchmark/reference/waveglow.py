"""WaveGlow's inverse pass (mel -> audio), plain PyTorch in float32: the
reference of the vocoder cells, written from the published model
(guanlongzhao/fac-via-ppg src/waveglow/glow.py:62-293, NVIDIA's WaveGlow)
and importing nothing of the program.

The weights are the benchmark's own (core/weights.py), in the layouts of
PyTorch's modules: ConvTranspose1d (in, out, k), Conv1d (out, in, k), the
invertible 1x1 convs as (c, c) matrices whose inverses are computed here
in float64.  The noise is drawn from the generator the program was given,
in the order the program's inverse pass takes it (`draw_noise`).

`quant="fp8"` is the control: every product inside the coupling nets
(start, dilated in, cond, res_skip and end convs) takes its input and
weight rounded to float8 e4m3 with one scale per tensor, as a serving
path one precision below bf16 would.

`store` rounds the audio held between the flows (the scaled noise, each
flow's output, the early outputs) to that dtype, every product staying
float32: the error that storing the audio in the serving dtype alone
makes on these weights, the yardstick of the vocoder's comparison."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.counts.models import waveglow_flow_channels


def draw_noise(wg: dict, B: int, G: int, gen: torch.Generator,
               device) -> list:
    """The unit-variance draws of one inverse pass of B rows of G groups:
    the (B, n_remaining, G) start, then one (B, n_early_size, G) block per
    early output, flows in descending order."""
    chans = waveglow_flow_channels(wg)
    out = [torch.randn((B, chans[-1], G), generator=gen, device=device)]
    out += [torch.randn((B, wg["n_early_size"], G), generator=gen,
                        device=device)
            for k in reversed(range(wg["n_flows"]))
            if k % wg["n_early_every"] == 0 and k > 0]
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _conv(x, p, quant, padding=0, dilation=1):
    w = p["weight"].float()
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv1d(x, w, p["bias"].float(), padding=padding,
                    dilation=dilation)


def coupling_net(wg: dict, wn: dict, audio: torch.Tensor,
                 spect: torch.Tensor, quant: Optional[str] = None):
    """WN (glow.py:100-155): (B, n_half, G), (B, M*n_group, G) ->
    (B, 2*n_half, G)."""
    cfg = wg["WN_config"]
    C, L, k = cfg["n_channels"], cfg["n_layers"], cfg["kernel_size"]
    audio = _conv(audio, wn["start"], quant)
    output = torch.zeros_like(audio)
    for i in range(L):
        d = 2 ** i
        in_act = (_conv(audio, wn["in_layers"][i], quant,
                        padding=(k * d - d) // 2, dilation=d)
                  + _conv(spect, wn["cond_layers"][i], quant))
        acts = torch.tanh(in_act[:, :C]) * torch.sigmoid(in_act[:, C:])
        res_skip = _conv(acts, wn["res_skip_layers"][i], quant)
        if i < L - 1:
            audio = audio + res_skip[:, :C]
            output = output + res_skip[:, C:]
        else:
            output = output + res_skip
    return _conv(output, wn["end"], quant)


def infer(wg: dict, hop: int, params: dict, mel: torch.Tensor,
          sigma: float, noise: list, quant: Optional[str] = None,
          store: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, M, F) mel -> (B, F*hop) audio (glow.py:252-293)."""

    def held(x):
        return x if store is None else x.to(store).float()

    up = params["upsample"]
    spect = F.conv_transpose1d(mel.float(), up["weight"].float(),
                               up["bias"].float(), stride=hop)
    K = up["weight"].shape[2]
    spect = spect[:, :, :-(K - hop)]                 # F * hop samples
    ng = wg["n_group"]
    B = spect.shape[0]
    spect = spect.unfold(2, ng, ng).permute(0, 2, 1, 3)
    spect = spect.reshape(B, spect.shape[1], -1).permute(0, 2, 1)
    draws = iter(noise)
    audio = held(sigma * next(draws).float())
    for k in reversed(range(wg["n_flows"])):
        n_half = audio.shape[1] // 2
        a0, a1 = audio[:, :n_half], audio[:, n_half:]
        out = coupling_net(wg, params["wn"][k], a0, spect, quant)
        s, b = out[:, n_half:], out[:, :n_half]
        a1 = (a1 - b) * torch.exp(-s)
        audio = torch.cat([a0, a1], dim=1)
        w = params["convinv"][k]["weight"]
        w_inv = torch.linalg.inv(w.double()).float()
        audio = held(F.conv1d(audio, w_inv[:, :, None]))
        if k % wg["n_early_every"] == 0 and k > 0:
            audio = torch.cat([held(sigma * next(draws).float()), audio],
                              dim=1)
    return audio.permute(0, 2, 1).reshape(B, -1)


# ------------------------------------------------------------------ training

def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float) -> torch.Tensor:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with its
    defaults (Slaney's mel scale, area normalization), float64."""
    import numpy as np

    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10)
                                             / min_log_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    ramps = edges[:, None] - freqs[None, :]
    fdiff = np.diff(edges)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return torch.as_tensor(w)


def log_mel(audio: torch.Tensor, data: dict, n_mels: int) -> torch.Tensor:
    """(B, T) audio in [-1, 1] -> (B, n_mel, T // hop + 1) log-mel
    (src/common/layers.py TacotronSTFT): the magnitude STFT of the
    reflect-padded signal under a periodic Hann window, the mel basis,
    log(max(., 1e-5))."""
    n_fft, hop = data["filter_length"], data["hop_length"]
    window = torch.hann_window(data["win_length"], periodic=True,
                               dtype=torch.float64, device=audio.device)
    spec = torch.stft(audio.double(), n_fft, hop, data["win_length"],
                      window, center=True, pad_mode="reflect",
                      return_complex=True).abs()
    basis = mel_basis(data["sampling_rate"], n_fft, n_mels,
                      data["mel_fmin"], data["mel_fmax"]).to(audio.device)
    return torch.log(torch.clamp(basis @ spec, min=1e-5)).float()


def train_form(params: dict) -> dict:
    """The folded weights -> weight norm's (g, v, bias) for every WN conv
    but the end conv (torch.nn.utils.weight_norm, dim 0): g = ||w|| per
    output channel, v = w."""
    def split(p):
        w = p["weight"]
        return {"g": torch.sqrt((w ** 2).sum(dim=(1, 2))), "v": w,
                "bias": p["bias"]}

    wn = [{"start": split(n["start"]), "end": n["end"],
           "in_layers": [split(p) for p in n["in_layers"]],
           "cond_layers": [split(p) for p in n["cond_layers"]],
           "res_skip_layers": [split(p) for p in n["res_skip_layers"]]}
          for n in params["wn"]]
    return {"upsample": params["upsample"], "convinv": params["convinv"],
            "wn": wn}


def _folded(p: dict) -> dict:
    if "g" not in p:
        return p
    v = p["v"]
    norm = torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True))
    return {"weight": p["g"][:, None, None] * v / norm, "bias": p["bias"]}


def forward(wg: dict, hop: int, params: dict, mel: torch.Tensor,
            audio: torch.Tensor):
    """The training pass (glow.py:215-250) on the train form: (z, log_s
    list, log_det_W list)."""
    up = params["upsample"]
    spect = F.conv_transpose1d(mel, up["weight"], up["bias"], stride=hop)
    T = audio.shape[1]
    spect = spect[:, :, :T]
    ng = wg["n_group"]
    B = mel.shape[0]
    spect = spect.unfold(2, ng, ng).permute(0, 2, 1, 3)
    spect = spect.reshape(B, spect.shape[1], -1).permute(0, 2, 1)
    audio = audio.unfold(1, ng, ng).permute(0, 2, 1)
    outs, log_s_list, log_det = [], [], []
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            outs.append(audio[:, :wg["n_early_size"]])
            audio = audio[:, wg["n_early_size"]:]
        w = params["convinv"][k]["weight"]
        audio = F.conv1d(audio, w[:, :, None])
        log_det.append(B * audio.shape[2] * torch.logdet(w))
        n_half = audio.shape[1] // 2
        wn = params["wn"][k]
        folded = {name: ([_folded(p) for p in v] if isinstance(v, list)
                         else _folded(v)) for name, v in wn.items()}
        out = coupling_net(wg, folded, audio[:, :n_half], spect)
        log_s, b = out[:, n_half:], out[:, :n_half]
        audio = torch.cat([audio[:, :n_half],
                           torch.exp(log_s) * audio[:, n_half:] + b], dim=1)
        log_s_list.append(log_s)
    outs.append(audio)
    return torch.cat(outs, dim=1), log_s_list, log_det


def loss(out, sigma: float):
    """WaveGlowLoss (glow.py:43-59): z^2 / (2 sigma^2) - sum(log_s) -
    sum(log_det_W), over z's elements; and the sum of its three terms'
    sizes, over the same count."""
    z, log_s_list, log_det = out
    terms = ((z * z).sum() / (2 * sigma * sigma),
             sum(s.sum() for s in log_s_list), sum(log_det))
    total = (terms[0] - terms[1] - terms[2]) / z.numel()
    return total, sum(abs(float(t.detach())) for t in terms) / z.numel()
