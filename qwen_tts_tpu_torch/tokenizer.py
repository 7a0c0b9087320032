"""The speech-tokenizer wrapper (PyTorch counterpart of
``qwen_tts_tpu/tokenizer.py``, the reference ``Qwen3TTSTokenizer``): reads a
speech tokenizer's directory and exposes ``encode`` (waveforms → codes) and
``decode`` (codes → 24 kHz waveforms).

The 12 Hz family (``qwen3_tts_tokenizer_12hz``) only: codes [T, 16], encoded
by the Mimi encoder (``codec_encoder.py``, read at the first ``encode``) and
decoded by the codec (``models/codec.py``, ``chunked_decode``). A 25 Hz
directory (``qwen3_tts_tokenizer_25hz``) raises ``NotImplementedError``: that
family is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from qwen_tts_tpu_torch import audio
from qwen_tts_tpu_torch.codec_encoder import SpeechTokenizerEncoder
from qwen_tts_tpu_torch.config import CodecConfig
from qwen_tts_tpu_torch.io.loader import load_codec
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models import codec as codec_mod
from qwen_tts_tpu_torch.utils import Device, resolve_device

MODEL_TYPE_12HZ = "qwen3_tts_tokenizer_12hz"
MODEL_TYPE_25HZ = "qwen3_tts_tokenizer_25hz"


class Qwen3TTSTokenizer:
    def __init__(self, model_type: str, cfg: CodecConfig, params: dict,
                 model_dir: Optional[str] = None):
        self.model_type = model_type
        self.cfg = cfg
        self.params = params
        self.model_dir = model_dir
        self.device = params["pre_conv_w"].device
        self._encoder: Optional[SpeechTokenizerEncoder] = None

    @classmethod
    def from_pretrained(cls, model_dir: str, *, dtype=torch.float32,
                        device: Device = None) -> "Qwen3TTSTokenizer":
        """Read ``model_dir/config.json`` and the codec's weights onto
        ``device`` (CUDA unless given), in ``dtype``."""
        with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
            raw = json.load(f)
        model_type = raw.get("model_type", MODEL_TYPE_12HZ)
        if model_type == MODEL_TYPE_25HZ:
            raise NotImplementedError(
                "the 25 Hz speech tokenizer (qwen3_tts_tokenizer_25hz) is not ported to "
                "qwen_tts_tpu_torch yet (ROADMAP.md, section 1: the 25 Hz tokenizer); use the "
                "12 Hz family")
        cfg = CodecConfig.from_dict(raw)
        st = MultiSafeTensors(model_dir)
        try:
            params = load_codec(st, cfg.decoder, dtype, resolve_device(device))
        finally:
            st.close()
        return cls(model_type, cfg, params, model_dir)

    def get_model_type(self) -> str:
        return self.model_type

    def get_output_sample_rate(self) -> int:
        return self.cfg.output_sample_rate

    def get_input_sample_rate(self) -> int:
        return self.cfg.input_sample_rate

    def get_decode_upsample_rate(self) -> int:
        return self.cfg.decode_upsample_rate

    def get_encode_downsample_rate(self) -> int:
        return self.cfg.encode_downsample_rate

    # ------------------------------------------------------------------

    def load_audio(self, x: str, target_sr: int) -> np.ndarray:
        """A WAV path, URL or base64 string → mono float32 at ``target_sr``."""
        wav, sr = audio.load_audio(x)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        return audio.resample(wav.astype(np.float32), sr, target_sr)

    def _normalize_inputs(self, audios, sample_rate: Optional[int]
                          ) -> Tuple[List[np.ndarray], int]:
        """A string (path, URL, base64), a numpy waveform with
        ``sample_rate``, an ``(ndarray, sr)`` tuple, or a list of them → the
        waveforms at the model's input rate. Numpy input without a rate is
        refused."""
        if isinstance(audios, np.ndarray):
            if sample_rate is None:
                raise ValueError("For numpy waveform input, provide sample_rate.")
            audios = [(audios, int(sample_rate))]
        elif (isinstance(audios, (list, tuple)) and audios
              and isinstance(audios[0], np.ndarray)
              and not (len(audios) == 2 and isinstance(audios[1], (int, np.integer)))):
            if sample_rate is None:
                raise ValueError("For numpy waveform input, provide sample_rate.")
            audios = [(a, int(sample_rate)) for a in audios]
        target = int(self.get_input_sample_rate())
        return [audio.resample(w, sr, target) if sr != target else w
                for w, sr in audio.normalize_audio_inputs(audios)], target

    def encode(self, wavs, sample_rate: Optional[int] = None) -> dict:
        """``{"audio_codes": [codes [T_i, Q] int32, ...]}``, one per clip."""
        wavs, sample_rate = self._normalize_inputs(wavs, sample_rate)
        if self._encoder is None:
            self._encoder = SpeechTokenizerEncoder.from_pretrained(self.model_dir,
                                                                   device=self.device)
        return {"audio_codes": self._encoder.encode(wavs, sample_rate)}

    def decode(self, encoded) -> Tuple[List[np.ndarray], int]:
        """Codes → (waveforms, output rate). ``encoded`` is ``encode``'s
        output or any dict with ``audio_codes`` (a list of [T_i, Q] codes),
        or a list of dicts with one clip's ``audio_codes`` each."""
        if isinstance(encoded, list):
            codes = [np.asarray(e["audio_codes"]) for e in encoded]
        elif isinstance(encoded, dict):
            codes = [np.asarray(c) for c in encoded["audio_codes"]]
        else:
            raise TypeError("encoded must be a dict or list of dicts")
        return self._decode_v2(codes)

    def _decode_v2(self, codes_list: List[np.ndarray]) -> Tuple[List[np.ndarray], int]:
        """The clips batched with -1 padding (the codec is causal, so the
        padding reaches no kept sample), ``chunked_decode``, each row cut to
        its length x ``decode_upsample_rate``."""
        dec = self.cfg.decoder
        lengths = [c.shape[0] for c in codes_list]
        batch = np.full((len(codes_list), max(lengths), dec.num_quantizers), -1, np.int64)
        for i, c in enumerate(codes_list):
            batch[i, : c.shape[0]] = c[:, : dec.num_quantizers]
        wav = codec_mod.chunked_decode(self.params, dec,
                                       torch.as_tensor(batch, device=self.device)).cpu().numpy()
        up = self.cfg.decode_upsample_rate
        return ([wav[i, : n * up] for i, n in enumerate(lengths)],
                self.cfg.output_sample_rate)
