"""ECAPA-TDNN speaker encoder and its mel-spectrogram frontend (PyTorch
counterpart of ``qwen_tts_tpu/models/speaker.py``; Base checkpoints).

The x-vector it produces takes the speaker slot of a voice-clone prompt.

  initial TDNN (conv k=5 + ReLU) → SE-Res2Net blocks (1x1 TDNN → Res2Net
  with dilated k=3 convs → 1x1 TDNN → squeeze-excitation, residual) →
  multi-layer feature aggregation over the blocks' outputs → attentive
  statistics pooling → linear to ``enc_dim``.

Every conv pads "same" in **reflect** mode. The mel frontend: slaney-norm
filterbank, periodic Hann window, a ``(n_fft - hop) // 2`` reflect pre-pad,
magnitude ``sqrt(|S|² + 1e-9)``, log of the value clipped at 1e-5.

Layout: PyTorch's channels-first ``[B, C, T]`` inside the encoder, conv
weights ``[C_out, C_in, K]`` as the checkpoint stores them; the SE block's and
the output's linears are ``[in, out]`` (``x @ w``). ``mel_spectrogram``
returns ``[B, T, n_mels]`` and ``speaker_encoder_forward`` takes that, as the
JAX functions do. A reflect pad here reflects as often as the pad needs, as
``numpy.pad`` does, so a clip shorter than a conv's reach still encodes.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import SpeakerEncoderConfig
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.utils import normal_init

# --------------------------------------------------------------------------
# Reflect padding of any length
# --------------------------------------------------------------------------


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Pad the last axis by reflection without repeating the edge, as
    ``numpy.pad(mode="reflect")`` does for any pad length: a pad longer than
    the axis reflects again off the far edge (``F.pad(mode="reflect")``
    refuses a pad that reaches the axis's length)."""
    if left == right == 0:
        return x
    n = x.shape[-1]
    period = max(2 * (n - 1), 1)
    j = torch.arange(-left, n + right, device=x.device) % period
    return x.index_select(-1, torch.where(j < n, j, period - j))


# --------------------------------------------------------------------------
# Mel frontend
# --------------------------------------------------------------------------

def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank
    (``librosa.filters.mel``). Returns [n_mels, n_fft // 2 + 1] float32."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_spectrogram(
    wav: torch.Tensor,  # [B, L] in [-1, 1]
    *,
    n_fft: int = 1024,
    num_mels: int = 128,
    sampling_rate: int = 24000,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 12000.0,
) -> torch.Tensor:
    """Returns the log-mel [B, T_frames, num_mels] (float32)."""
    mel = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)).to(
        wav.device)
    pad = (n_fft - hop_size) // 2
    frames = reflect_pad(wav.float(), pad, pad).unfold(-1, n_fft, hop_size)  # [B, T, n_fft]
    n = torch.arange(n_fft, dtype=torch.float32, device=wav.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * torch.pi * n / n_fft))  # periodic Hann
    spec = torch.fft.rfft(frames * window, dim=-1)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
    return torch.log(torch.clamp(mag @ mel.T, min=1e-5))


# --------------------------------------------------------------------------
# ECAPA-TDNN
# --------------------------------------------------------------------------

def _same_reflect_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int = 1) -> torch.Tensor:
    """Conv1d with torch's padding="same", padding_mode="reflect".
    x: [B, C_in, T]; w: [C_out, C_in, K]."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    left = (k_eff - 1) // 2
    x = reflect_pad(x, left, k_eff - 1 - left)
    return F.conv1d(x, w, b, dilation=dilation)


def _tdnn(p: dict, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    return torch.relu(_same_reflect_conv(x, p["w"], p["b"], dilation))


def _res2net(blocks: List[dict], x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    parts = torch.chunk(x, scale, dim=1)
    outs = [parts[0]]
    prev = None
    for i in range(1, scale):
        inp = parts[i] if i == 1 else parts[i] + prev
        prev = _tdnn(blocks[i - 1], inp, dilation)
        outs.append(prev)
    return torch.cat(outs, dim=1)


def _se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=2)
    s = torch.relu(s @ p["w1"] + p["b1"])
    s = torch.sigmoid(s @ p["w2"] + p["b2"])
    return x * s[:, :, None]


def _asp(p: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Attentive statistics pooling. x: [B, C, T] → [B, 2C]."""
    mean = x.mean(dim=2, keepdim=True)
    std = torch.sqrt(torch.clamp((x - mean).square().mean(dim=2, keepdim=True), min=eps))
    attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
    a = torch.tanh(_tdnn(p["tdnn"], attn_in))
    a = torch.softmax(_same_reflect_conv(a, p["conv_w"], p["conv_b"]), dim=2)
    mean = (a * x).sum(dim=2)
    std = torch.sqrt(torch.clamp((a * (x - mean[:, :, None]).square()).sum(dim=2), min=eps))
    return torch.cat([mean, std], dim=-1)


def speaker_encoder_forward(params: dict, cfg: SpeakerEncoderConfig,
                            mels: torch.Tensor) -> torch.Tensor:
    """mels: [B, T, mel_dim] → x-vector [B, enc_dim] (float32). On the card
    cuDNN's convolutions run without TF32, so the x-vector is the f32 one."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        h = _tdnn(params["blocks"][0], mels.float().transpose(1, 2), cfg.enc_dilations[0])
        feats = []
        for i, blk in enumerate(params["blocks"][1:], start=1):
            residual = h
            h = _tdnn(blk["tdnn1"], h)
            h = _res2net(blk["res2net"], h, cfg.enc_res2net_scale, cfg.enc_dilations[i])
            h = _tdnn(blk["tdnn2"], h)
            h = _se_block(blk["se"], h) + residual
            feats.append(h)
        h = _tdnn(params["mfa"], torch.cat(feats, dim=1), cfg.enc_dilations[-1])
        return _asp(params["asp"], h) @ params["fc_w"] + params["fc_b"]


# --------------------------------------------------------------------------
# Init / loading
# --------------------------------------------------------------------------

def init_speaker_params(generator: torch.Generator, cfg: SpeakerEncoderConfig,
                        dtype=torch.float32, device=None) -> dict:
    """Random ECAPA-TDNN weights (tests without a checkpoint) in the
    loader's layout (convs ``[C_out, C_in, K]``, linears ``[in, out]``):
    weights N(0, 1/fan_in) with fan_in = C_in x K or the linear's input,
    biases zeros. The JAX package's keys and dtypes; its convs are the same
    weights stored ``[K, C_in, C_out]``."""
    device = device if device is not None else generator.device
    ch, ks = cfg.enc_channels, cfg.enc_kernel_sizes

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def lin(cin, cout):
        return normal_init((cin, cout), cin, generator, dtype, device)

    def tdnn(cin, cout, k):
        return {"w": normal_init((cout, cin, k), cin * k, generator, dtype, device),
                "b": zeros(cout)}

    blocks: List[dict] = [tdnn(cfg.mel_dim, ch[0], ks[0])]
    for i in range(1, len(ch) - 1):
        width = ch[i] // cfg.enc_res2net_scale
        blocks.append({
            "tdnn1": tdnn(ch[i - 1], ch[i], 1),
            "res2net": [tdnn(width, width, ks[i]) for _ in range(cfg.enc_res2net_scale - 1)],
            "tdnn2": tdnn(ch[i], ch[i], 1),
            "se": {"w1": lin(ch[i], cfg.enc_se_channels), "b1": zeros(cfg.enc_se_channels),
                   "w2": lin(cfg.enc_se_channels, ch[i]), "b2": zeros(ch[i])},
        })
    asp = tdnn(cfg.enc_attention_channels, ch[-1], 1)
    return {
        "blocks": blocks,
        "mfa": tdnn(sum(ch[1:-1]), ch[-1], ks[-1]),
        "asp": {"tdnn": tdnn(ch[-1] * 3, cfg.enc_attention_channels, 1),
                "conv_w": asp["w"], "conv_b": asp["b"]},
        "fc_w": lin(ch[-1] * 2, cfg.enc_dim),
        "fc_b": zeros(cfg.enc_dim),
    }


def load_speaker_encoder(st: MultiSafeTensors, cfg: SpeakerEncoderConfig,
                         device: torch.device, prefix: str = "speaker_encoder.") -> dict:
    """ECAPA-TDNN weights under ``prefix`` (float32 on ``device``): convs as
    stored, ``[C_out, C_in, K]``; the 1-tap convs that act as linears (SE
    block, output) as ``[in, out]``."""

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=torch.float32, copy=True).contiguous()

    def conv(name: str) -> dict:
        return {"w": put(st.get_f32(name + ".weight")), "b": put(st.get_f32(name + ".bias"))}

    def lin_from_conv1(name: str):
        return (put(st.get_f32(name + ".weight")[:, :, 0].t()),
                put(st.get_f32(name + ".bias")))

    p = prefix
    ch = cfg.enc_channels
    blocks: List[dict] = [conv(p + "blocks.0.conv")]
    for i in range(1, len(ch) - 1):
        b = f"{p}blocks.{i}."
        se1_w, se1_b = lin_from_conv1(b + "se_block.conv1")
        se2_w, se2_b = lin_from_conv1(b + "se_block.conv2")
        blocks.append({
            "tdnn1": conv(b + "tdnn1.conv"),
            "res2net": [conv(f"{b}res2net_block.blocks.{j}.conv")
                        for j in range(cfg.enc_res2net_scale - 1)],
            "tdnn2": conv(b + "tdnn2.conv"),
            "se": {"w1": se1_w, "b1": se1_b, "w2": se2_w, "b2": se2_b},
        })
    fc_w, fc_b = lin_from_conv1(p + "fc")
    asp_conv = conv(p + "asp.conv")
    return {
        "blocks": blocks,
        "mfa": conv(p + "mfa.conv"),
        "asp": {"tdnn": conv(p + "asp.tdnn.conv"), "conv_w": asp_conv["w"],
                "conv_b": asp_conv["b"]},
        "fc_w": fc_w,
        "fc_b": fc_b,
    }
