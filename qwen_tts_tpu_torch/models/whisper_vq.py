"""25 Hz Whisper-VQ encoder (encode only): 16 kHz waveform → codes (PyTorch
counterpart of ``qwen_tts_tpu/models/whisper_vq.py``).

A Whisper-style encoder (two convs, the second of stride 2, then sinusoid
positions and a pre-LN transformer whose attention stays inside windows of
``n_window`` rows) cut after ``audio_vq_layers`` layers, then a stride
``audio_vq_ds_rate`` conv and one vector quantizer: the nearest codeword
after an optional input projection.

Each waveform's log-mel (host numpy) is cut into windows of ``2 n_window``
mel frames; windows ride the batch axis, a ragged last window is masked.
The trunk runs over bounded groups of windows (``WINDOW_GROUP``), not one
call of unbounded size; a window's output does not depend on its group.
Convs are channels-first with PyTorch's ``[C_out, C_in, K]`` weights, the
linears ``[in, out]``. Everything is float32; on the card without TF32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models.speaker import mel_filterbank
from qwen_tts_tpu_torch.utils import Device, full_f32, normal_init, resolve_device

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16000
# Chunk windows the trunk takes in one call (the last group may hold fewer).
WINDOW_GROUP = 64


@dataclasses.dataclass(frozen=True)
class WhisperVQConfig:
    """Reference: configuration_qwen3_tts_tokenizer_v1.py encoder config."""

    n_mels: int = 128
    n_ctx: int = 1500
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 32
    n_window: int = 100
    output_dim: int = 3584
    audio_vq_layers: int = 16
    audio_vq_codebook_size: int = 4096
    audio_vq_codebook_dim: int = 512
    audio_vq_ds_rate: int = 2

    @classmethod
    def from_dict(cls, d) -> "WhisperVQConfig":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in keys})


def whisper_log_mel(audio: np.ndarray, n_mels: int = 128, padding: int = 0) -> np.ndarray:
    """Whisper log-mel: centred STFT (reflect pad), power spectrum without
    the last frame, slaney mel, log10 floored at max - 8, (x + 4) / 4.
    Returns [n_mels, T] (host numpy)."""
    audio = np.asarray(audio, np.float32)
    if padding > 0:
        audio = np.pad(audio, (0, padding))
    pad = N_FFT // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (x.shape[0] - N_FFT) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)  # periodic Hann
    spec = np.fft.rfft(x[idx] * window, axis=-1)
    magnitudes = (np.abs(spec[:-1]) ** 2).T  # drop the last frame → [freq, T]
    mel = mel_filterbank(SAMPLE_RATE, N_FFT, n_mels, 0, SAMPLE_RATE / 2)
    log_spec = np.log10(np.clip(mel @ magnitudes, 1e-10, None))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def v1_ref_mel(audio_16k: np.ndarray) -> np.ndarray:
    """The BigVGAN-style reference mel of the DiT's conditioning: n_fft
    1024, hop 160, window 640 (zero-padded to n_fft, centred), 80 slaney
    mels up to 8 kHz, reflect pre-pad (n_fft - hop) / 2, no centring,
    magnitude sqrt(|S|^2 + 1e-9), log of the value clipped at 1e-5. Returns
    [T, 80] (host numpy)."""
    n_fft, hop, win, n_mels = 1024, 160, 640, 80
    audio = np.asarray(audio_16k, np.float32)
    pad = (n_fft - hop) // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (x.shape[0] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = np.zeros(n_fft, np.float32)
    start = (n_fft - win) // 2
    window[start : start + win] = np.hanning(win + 1)[:-1]
    spec = np.fft.rfft(x[idx] * window, axis=-1)
    mag = np.sqrt(np.real(spec) ** 2 + np.imag(spec) ** 2 + 1e-9).T
    mel = mel_filterbank(SAMPLE_RATE, n_fft, n_mels, 0, 8000)
    return np.log(np.clip(mel @ mag, 1e-5, None)).T.astype(np.float32)


def _conv_stem(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, T, n_mels] → [B, T // 2, n_state]: conv k3 p1 + GELU, conv
    k3 s2 p1 + GELU (exact GELU)."""
    h = F.gelu(F.conv1d(mel.transpose(1, 2), params["conv1_w"], params["conv1_b"], padding=1))
    h = F.gelu(F.conv1d(h, params["conv2_w"], params["conv2_b"], stride=2, padding=1))
    return h.transpose(1, 2)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (((x32 - mean) * torch.rsqrt(var + eps)) * w + b).to(x.dtype)


def _mha(layer: dict, x: torch.Tensor, mask: torch.Tensor, n_head: int) -> torch.Tensor:
    """Bidirectional attention within each window (the batch axis); the key
    projection has no bias. mask: [B, T] True = real."""
    b, t_len, d = x.shape
    hd = d // n_head
    q = (x @ layer["wq"] + layer["bq"]).view(b, t_len, n_head, hd)
    k = (x @ layer["wk"]).view(b, t_len, n_head, hd)
    v = (x @ layer["wv"] + layer["bv"]).view(b, t_len, n_head, hd)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) * (hd ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", probs, v)
    return out.reshape(b, t_len, d) @ layer["wo"] + layer["bo"]


def encoder_trunk(params: dict, cfg: WhisperVQConfig, windows: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """windows: [B, W, n_state] after the stem and positions; layers
    1..audio_vq_layers."""
    x = windows
    for layer in params["layers"][: cfg.audio_vq_layers]:
        x = x + _mha(layer, _layer_norm(x, layer["attn_ln_w"], layer["attn_ln_b"]), mask,
                     cfg.n_head)
        h = _layer_norm(x, layer["mlp_ln_w"], layer["mlp_ln_b"])
        h = F.gelu(h @ layer["mlp1_w"] + layer["mlp1_b"])
        x = x + (h @ layer["mlp2_w"] + layer["mlp2_b"])
    return x


def vq_encode(params: dict, cfg: WhisperVQConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [N, n_state] → codes [N] (int64): the nearest codeword after the
    input projection, if any."""
    return torch.argmin(vq_distances(params, x), dim=-1)


def vq_distances(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The squared distances [N, size] ``vq_encode`` takes the argmin of."""
    if "vq_proj_in_w" in params:
        x = x @ params["vq_proj_in_w"] + params["vq_proj_in_b"]
    embed = params["vq_embed"]  # [size, dim]
    return ((x * x).sum(-1, keepdim=True) - 2.0 * x @ embed.T
            + (embed * embed).sum(-1)[None, :])


def _encode_windows(params: dict, cfg: WhisperVQConfig, windows: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """[C, 2W_mel, n_mels] chunk windows → [C, W, n_state]."""
    h = _conv_stem(params, windows)
    return encoder_trunk(params, cfg, h + params["positional_embedding"][None, : h.shape[1]],
                         mask)


def _ds_features(params: dict, cfg: WhisperVQConfig, feats: torch.Tensor) -> torch.Tensor:
    """One waveform's valid features [T, n_state] → the quantizer's input
    [T // ds, n_state] (the downsampling conv's kernel is its stride)."""
    ds = cfg.audio_vq_ds_rate
    if "ds_w" not in params or ds <= 1:
        return feats
    return F.conv1d(feats.t()[None], params["ds_w"], params["ds_b"], stride=ds)[0].t()


def _windows(wav: np.ndarray, cfg: WhisperVQConfig):
    """A waveform's chunk windows [n, 2 n_window, n_mels] and each window's
    valid rows after the stem."""
    w_mel = cfg.n_window * 2
    reduction = HOP * 2 * cfg.audio_vq_ds_rate
    pad = math.ceil(len(wav) / reduction) * reduction - len(wav)
    mel = whisper_log_mel(wav, cfg.n_mels, padding=pad).T  # [T, n_mels]
    t_mel = mel.shape[0]
    n_chunks = math.ceil(t_mel / w_mel)
    padded = np.zeros((n_chunks, w_mel, cfg.n_mels), np.float32)
    for c in range(n_chunks):
        seg = mel[c * w_mel : (c + 1) * w_mel]
        padded[c, : seg.shape[0]] = seg
    return padded, [min(w_mel, t_mel - c * w_mel) // 2 for c in range(n_chunks)]


def encode_features(params: dict, cfg: WhisperVQConfig, wavs: Sequence[np.ndarray],
                    group: int = WINDOW_GROUP) -> List[torch.Tensor]:
    """Each 16 kHz waveform → the quantizer's input [T_codes, n_state] on
    the parameters' device. The windows of all waveforms go through the
    trunk ``group`` at a time."""
    if not wavs:
        return []
    device = params["conv1_w"].device
    per_wav = [_windows(np.asarray(w, np.float32), cfg) for w in wavs]
    windows = np.concatenate([p for p, _ in per_wav])
    lens = [n for _, chunk_lens in per_wav for n in chunk_lens]
    mask = np.arange(cfg.n_window)[None, :] < np.asarray(lens)[:, None]
    with full_f32():
        h = torch.cat([
            _encode_windows(params, cfg, torch.as_tensor(windows[i : i + group], device=device),
                            torch.as_tensor(mask[i : i + group], device=device))
            for i in range(0, len(lens), group)])
        out, offset = [], 0
        for _, chunk_lens in per_wav:
            feats = torch.cat([h[offset + c, :n] for c, n in enumerate(chunk_lens)])
            offset += len(chunk_lens)
            out.append(_ds_features(params, cfg, feats))
    return out


def encode_waveforms(params: dict, cfg: WhisperVQConfig, wavs: Sequence[np.ndarray],
                     group: int = WINDOW_GROUP) -> List[np.ndarray]:
    """Each 16 kHz waveform → its codes [ceil(len / (HOP * 2 * ds))]
    (int32, host numpy)."""
    feats = encode_features(params, cfg, wavs, group)
    with full_f32():
        codes = [vq_encode(params, cfg, f) for f in feats]
    return [c.cpu().numpy().astype(np.int32) for c in codes]


def load_whisper_vq(st: MultiSafeTensors, cfg: WhisperVQConfig, device: Device = None,
                    prefix: str = "encoder.tokenizer.") -> dict:
    """Whisper-VQ weights under ``prefix`` in float32 on ``device`` (CUDA
    unless given): linears [in, out], convs as stored, the codebook [size,
    dim]."""
    device = resolve_device(device)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=torch.float32, copy=True).contiguous()

    def lin(name: str) -> torch.Tensor:
        return put(st.get_f32(name).t())

    def vec(name: str) -> torch.Tensor:
        return put(st.get_f32(name))

    p = prefix
    layers = []
    for i in range(cfg.audio_vq_layers):
        b = f"{p}blocks.{i}."
        layers.append({
            "attn_ln_w": vec(b + "attn_ln.weight"), "attn_ln_b": vec(b + "attn_ln.bias"),
            "wq": lin(b + "attn.query.weight"), "bq": vec(b + "attn.query.bias"),
            "wk": lin(b + "attn.key.weight"),
            "wv": lin(b + "attn.value.weight"), "bv": vec(b + "attn.value.bias"),
            "wo": lin(b + "attn.out.weight"), "bo": vec(b + "attn.out.bias"),
            "mlp_ln_w": vec(b + "mlp_ln.weight"), "mlp_ln_b": vec(b + "mlp_ln.bias"),
            "mlp1_w": lin(b + "mlp.0.weight"), "mlp1_b": vec(b + "mlp.0.bias"),
            "mlp2_w": lin(b + "mlp.2.weight"), "mlp2_b": vec(b + "mlp.2.bias"),
        })
    params = {
        "conv1_w": vec(p + "conv1.weight"), "conv1_b": vec(p + "conv1.bias"),
        "conv2_w": vec(p + "conv2.weight"), "conv2_b": vec(p + "conv2.bias"),
        "positional_embedding": vec(p + "positional_embedding"),
        "layers": layers,
        # One group, one quantizer: the codebook of rvqs.0.
        "vq_embed": vec(p + "audio_quantizer.rvqs.0.embed")[0].contiguous(),
    }
    if (p + "audio_vq_downsample.weight") in st:
        params["ds_w"] = vec(p + "audio_vq_downsample.weight")
        params["ds_b"] = vec(p + "audio_vq_downsample.bias")
    proj = p + "audio_quantizer.rvqs.0.layers.0.project_in."
    if (proj + "weight") in st:
        params["vq_proj_in_w"] = lin(proj + "weight")
        params["vq_proj_in_b"] = vec(proj + "bias")
    return params


def sinusoid_positions(n_ctx: int, d: int) -> np.ndarray:
    """Whisper's sinusoid positional embedding [n_ctx, d] in float32, as the
    JAX package's ``init_whisper_vq`` computes it (in float64 numpy)."""
    half = d // 2
    inc = np.log(10000) / (half - 1)
    inv = np.exp(-inc * np.arange(half))
    scaled = np.arange(n_ctx)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper_vq(generator: torch.Generator, cfg: WhisperVQConfig, dtype=torch.float32,
                    device=None) -> dict:
    """Random Whisper-VQ weights in ``load_whisper_vq``'s layout (convs
    ``[C_out, C_in, K]``, linears ``[in, out]``, the codebook ``[size,
    dim]``): N(0, 1/fan_in) weights, zero biases, LayerNorm weights ones, the
    sinusoid positions; ``ds_w`` / ``ds_b`` only when ``audio_vq_ds_rate`` >
    1, the codebook's input projection only when its dim is not
    ``n_state``. The JAX package's ``init_whisper_vq`` keys and shapes. On
    the ``meta`` device nothing is drawn."""
    device = device if device is not None else generator.device
    d = cfg.n_state

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    layers = [{
        "attn_ln_w": full(d, 1.0), "attn_ln_b": full(d, 0.0),
        "wq": w((d, d), d), "bq": full(d, 0.0),
        "wk": w((d, d), d),
        "wv": w((d, d), d), "bv": full(d, 0.0),
        "wo": w((d, d), d), "bo": full(d, 0.0),
        "mlp_ln_w": full(d, 1.0), "mlp_ln_b": full(d, 0.0),
        "mlp1_w": w((d, 4 * d), d), "mlp1_b": full(4 * d, 0.0),
        "mlp2_w": w((4 * d, d), 4 * d), "mlp2_b": full(d, 0.0),
    } for _ in range(cfg.audio_vq_layers)]
    dim = cfg.audio_vq_codebook_dim
    params = {
        "conv1_w": w((d, cfg.n_mels, 3), 3 * cfg.n_mels),
        "conv1_b": full(d, 0.0),
        "conv2_w": w((d, d, 3), 3 * d),
        "conv2_b": full(d, 0.0),
        "positional_embedding": torch.from_numpy(sinusoid_positions(cfg.n_ctx, d)).to(
            device=device, dtype=dtype),
        "layers": layers,
        "vq_embed": w((cfg.audio_vq_codebook_size, dim), dim),
    }
    ds = cfg.audio_vq_ds_rate
    if ds > 1:
        params["ds_w"] = w((d, d, ds), ds * d)
        params["ds_b"] = full(d, 0.0)
    if dim != d:
        params["vq_proj_in_w"] = w((d, dim), d)
        params["vq_proj_in_b"] = full(dim, 0.0)
    return params
