"""12 Hz speech-tokenizer encode path: waveforms → per-clip [T, Q] codec codes
(PyTorch counterpart of ``qwen_tts_tpu/codec_encoder.py``, native Mimi only).

Keeps the reference's trim: the first ``encoder_valid_num_quantizers``
codebooks, each clip's frames cut to ``ceil(n / encode_downsample_rate)``.
A batch is right-padded to a multiple of ``downsample_rate * 8`` samples
(the JAX package's length bucket, which bounds the shapes here too): every
encoder stage is causal, so the padding reaches only frames past a clip's end,
which the trim drops.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np
import torch

from qwen_tts_tpu_torch.audio import resample
from qwen_tts_tpu_torch.config import CodecConfig, MimiEncoderConfig
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models.mimi_encoder import load_mimi_encoder, mimi_encode
from qwen_tts_tpu_torch.utils import Device, resolve_device


class SpeechTokenizerEncoder:
    def __init__(self, cfg: MimiEncoderConfig, params: dict, valid_num_quantizers: int,
                 input_sample_rate: int, downsample_rate: int):
        self.cfg = cfg
        self.params = params
        self.valid_num_quantizers = valid_num_quantizers
        self.input_sample_rate = input_sample_rate
        self.downsample_rate = downsample_rate
        self.device = params["init_w"].device

    @classmethod
    def from_pretrained(cls, speech_tokenizer_dir: str, *,
                        device: Device = None) -> "SpeechTokenizerEncoder":
        """Read ``speech_tokenizer/config.json`` and the Mimi weights under
        ``encoder.`` onto ``device`` (CUDA unless given)."""
        device = resolve_device(device)
        with open(os.path.join(speech_tokenizer_dir, "config.json"), encoding="utf-8") as f:
            cfg = CodecConfig.from_dict(json.load(f))
        st = MultiSafeTensors(speech_tokenizer_dir)
        try:
            params = load_mimi_encoder(st, cfg.encoder, device)
        finally:
            st.close()
        return cls(cfg.encoder, params, cfg.encoder_valid_num_quantizers,
                   cfg.input_sample_rate, cfg.encode_downsample_rate)

    def encode(self, wavs: Sequence[np.ndarray], sample_rate: int) -> List[np.ndarray]:
        """Each waveform → [T_i, Q] int32 codes (per clip, unpadded)."""
        if sample_rate != self.input_sample_rate:
            wavs = [resample(w, sample_rate, self.input_sample_rate) for w in wavs]
        lengths = [w.shape[0] for w in wavs]
        bucket = max(self.downsample_rate * 8, 1)
        padded_len = -(-max(lengths) // bucket) * bucket
        batch = np.zeros((len(wavs), padded_len), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : w.shape[0]] = w
        with torch.inference_mode():
            codes = mimi_encode(self.params, self.cfg,
                                torch.as_tensor(batch, device=self.device))
        codes = codes[:, : self.valid_num_quantizers].cpu().numpy()
        return [np.ascontiguousarray(codes[i, :, : -(-n // self.downsample_rate)].T)
                .astype(np.int32) for i, n in enumerate(lengths)]


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """A linear-interpolation resampler (host numpy, float32): the JAX
    package's cold-path helper, kept beside ``audio.resample``."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    n_out = int(round(wav.shape[0] * sr_out / sr_in))
    x_out = np.linspace(0.0, wav.shape[0] - 1, n_out)
    return np.interp(x_out, np.arange(wav.shape[0]), wav).astype(np.float32)
