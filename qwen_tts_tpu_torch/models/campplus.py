"""CAM++ x-vector extraction for the 25 Hz voice-clone encode path (PyTorch
counterpart of ``qwen_tts_tpu/models/campplus.py``) — native, no onnxruntime
/ torchaudio / sox dependencies. The front end is host numpy, copied; the
graph runs on the port's executor on the tokenizer's device.

Mirrors the reference's XVectorExtractor pipeline exactly
(vq/speech_vq.py:118-160): peak-normalize to -6 dB (sox ``norm -6``) →
Kaldi fbank (80 mel bins, 16 kHz, dither 0) → per-utterance mean subtraction
→ the ``campplus.onnx`` graph (run by qwen_tts_tpu_torch.onnx_exec's
native executor) → flatten → L2 normalize.

The fbank follows Kaldi's computation (povey window, preemphasis 0.97, DC
removal, power spectrum on a 512-point FFT, Kaldi-scale mel triangles
without area normalization, natural log with float-eps floor) — the
torchaudio.compliance.kaldi semantics the reference calls.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from qwen_tts_tpu_torch.onnx_exec import OnnxModel
from qwen_tts_tpu_torch.utils import Device

_SAMPLE_RATE = 16000
_FRAME_LEN = 400      # 25 ms
_FRAME_SHIFT = 160    # 10 ms
_PADDED = 512         # next power of two
_PREEMPH = 0.97
_NUM_BINS = 80
_LOW_FREQ = 20.0
_HIGH_FREQ = 8000.0   # kaldi high_freq=0 → nyquist
_EPS = 1.1920928955078125e-07  # float32 eps (torchaudio's floor)


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def kaldi_mel_banks(num_bins: int = _NUM_BINS) -> np.ndarray:
    """[num_bins, padded//2] triangular filters on the Kaldi mel scale
    (no Slaney area normalization)."""
    num_fft_bins = _PADDED // 2
    fft_bin_width = _SAMPLE_RATE / _PADDED
    mel_low, mel_high = _mel(_LOW_FREQ), _mel(_HIGH_FREQ)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins), np.float32)
    freqs = _mel(fft_bin_width * np.arange(num_fft_bins))
    for j in range(num_bins):
        left = mel_low + j * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (freqs - left) / (center - left)
        down = (right - freqs) / (right - center)
        bins[j] = np.maximum(0.0, np.minimum(up, down))
    return bins


def _povey_window(n: int = _FRAME_LEN) -> np.ndarray:
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return (hann ** 0.85).astype(np.float64)


def kaldi_fbank(wav: np.ndarray, num_bins: int = _NUM_BINS) -> np.ndarray:
    """waveform (float, 16 kHz, any scale — Kaldi works on int16-scale but
    the graph input is scale-covariant only through the log, and the
    reference feeds float audio as-is) → [T, num_bins] log-mel."""
    x = np.asarray(wav, np.float64)
    n = x.shape[0]
    t = 1 + (n - _FRAME_LEN) // _FRAME_SHIFT  # snip_edges=True
    if t <= 0:
        return np.zeros((0, num_bins), np.float32)
    idx = (np.arange(t)[:, None] * _FRAME_SHIFT + np.arange(_FRAME_LEN)[None])
    frames = x[idx]                                   # [T, 400]
    frames = frames - frames.mean(axis=1, keepdims=True)  # remove_dc_offset
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - _PREEMPH * pre                  # preemphasis (kaldi edge)
    frames = frames * _povey_window()[None]
    spec = np.fft.rfft(frames, n=_PADDED, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : _PADDED // 2]
    mel = power @ kaldi_mel_banks(num_bins).T
    return np.log(np.maximum(mel, _EPS)).astype(np.float32)


def sox_norm(wav: np.ndarray, db_level: float = -6.0) -> np.ndarray:
    """sox ``norm -6``: scale so the peak sits at ``db_level`` dBFS."""
    x = np.asarray(wav, np.float32)
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    if peak <= 0.0:
        return x
    return x * (10.0 ** (db_level / 20.0) / peak)


class CampplusXVector:
    """Native CAM++ x-vector extractor driving ``campplus.onnx`` through the
    port's ONNX executor, on ``device`` (CUDA unless given). Reference: vq/speech_vq.py:118-160,
    modeling_qwen3_tts_tokenizer_v1.py:1426-1446."""

    def __init__(self, onnx_path: str, device: Device = None):
        try:
            self.model = OnnxModel(onnx_path, device)
        except Exception as exc:
            raise ValueError(
                f"failed to parse {onnx_path!r} as an ONNX model: {exc}"
            ) from exc
        if not self.model.input_names:
            raise ValueError(f"{onnx_path}: graph has no inputs")

    @classmethod
    def maybe_from_dir(cls, model_dir: str, device: Device = None
                       ) -> Optional["CampplusXVector"]:
        """The extractor of ``model_dir/campplus.onnx`` on ``device`` (CUDA
        unless given), or None without that file."""
        path = os.path.join(model_dir, "campplus.onnx")
        return cls(path, device) if os.path.exists(path) else None

    def extract(self, wav_16k: np.ndarray) -> np.ndarray:
        """16 kHz mono waveform → L2-normalized x-vector [D]."""
        norm = sox_norm(wav_16k)
        feat = kaldi_fbank(norm)
        feat = feat - feat.mean(axis=0, keepdims=True)
        (out,) = self.model.run(
            {self.model.input_names[0]: feat[None].astype(np.float32)},
            self.model.output_names[:1],
        )
        vec = np.asarray(out, np.float32).ravel()
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else vec
