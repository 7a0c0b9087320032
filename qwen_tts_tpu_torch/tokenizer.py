"""The speech-tokenizer wrapper (PyTorch counterpart of
``qwen_tts_tpu/tokenizer.py``, the reference ``Qwen3TTSTokenizer``): reads a
speech tokenizer's directory and exposes ``encode`` (waveforms → codes) and
``decode`` (codes → 24 kHz waveforms) for both families:

* ``qwen3_tts_tokenizer_12hz``: codes [T, 16], encoded by the Mimi encoder
  (``codec_encoder.py``, read at the first ``encode``) and decoded by the
  codec (``models/codec.py``, ``chunked_decode``).
* ``qwen3_tts_tokenizer_25hz``: codes [T] with an x-vector and a reference
  mel, decoded by the flow-matching DiT and BigVGAN
  (``models/codec_v1.py``); encoded by Whisper-VQ (``models/whisper_vq.py``,
  read from ``encoder_config`` at the first ``encode``), with the reference
  mel, and the CAM++ x-vector when the directory holds ``campplus.onnx``
  (``models/campplus.py``).

A 25 Hz row is cut at its codes' samples, ``repeats x total_upsample`` a
code (``CodecV1Config.samples_per_code``), which is what the decoder makes
for it; the JAX package cuts at ``decode_upsample_rate`` a code, which the
default config sets to twice that.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch import audio
from qwen_tts_tpu_torch.codec_encoder import SpeechTokenizerEncoder
from qwen_tts_tpu_torch.config import CodecConfig, CodecV1Config
from qwen_tts_tpu_torch.io.loader import load_codec
from qwen_tts_tpu_torch.io.loader_v1 import load_codec_v1
from qwen_tts_tpu_torch.io.safetensors import MultiSafeTensors
from qwen_tts_tpu_torch.models import codec as codec_mod
from qwen_tts_tpu_torch.models import codec_v1
from qwen_tts_tpu_torch.models import whisper_vq as wvq
from qwen_tts_tpu_torch.models.campplus import CampplusXVector
from qwen_tts_tpu_torch.utils import Device, resolve_device

MODEL_TYPE_12HZ = "qwen3_tts_tokenizer_12hz"
MODEL_TYPE_25HZ = "qwen3_tts_tokenizer_25hz"


class Qwen3TTSTokenizer:
    def __init__(self, model_type: str, cfg: Union[CodecConfig, CodecV1Config], params: dict,
                 model_dir: Optional[str] = None):
        self.model_type = model_type
        self.cfg = cfg
        self.params = params
        self.model_dir = model_dir
        self.device = (params["dit"]["in_proj_w"] if model_type == MODEL_TYPE_25HZ
                       else params["pre_conv_w"]).device
        # 12 Hz: the Mimi encoder; 25 Hz: (WhisperVQConfig, its weights).
        self._encoder = None
        self._xvector: Union[None, bool, CampplusXVector] = None  # False: no asset

    @classmethod
    def from_pretrained(cls, model_dir: str, *, dtype=torch.float32,
                        device: Device = None) -> "Qwen3TTSTokenizer":
        """Read ``model_dir/config.json`` and the decoder's weights onto
        ``device`` (CUDA unless given), in ``dtype``."""
        with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
            raw = json.load(f)
        model_type = raw.get("model_type", MODEL_TYPE_12HZ)
        device = resolve_device(device)
        if model_type == MODEL_TYPE_25HZ:
            cfg = CodecV1Config.from_dict(raw)
            return cls(model_type, cfg, load_codec_v1(model_dir, cfg, dtype, device), model_dir)
        cfg = CodecConfig.from_dict(raw)
        st = MultiSafeTensors(model_dir)
        try:
            params = load_codec(st, cfg.decoder, dtype, device)
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
        """12 Hz: ``{"audio_codes": [codes [T_i, Q] int32, ...]}``. 25 Hz:
        ``{"audio_codes": [codes [T_i] int32], "ref_mels": [[T_mel_i, 80]],
        "xvectors": [[D]] or None}`` (None without ``campplus.onnx``)."""
        wavs, sample_rate = self._normalize_inputs(wavs, sample_rate)
        if self.model_type == MODEL_TYPE_25HZ:
            return self._encode_v1(wavs, sample_rate)
        if self._encoder is None:
            self._encoder = SpeechTokenizerEncoder.from_pretrained(self.model_dir,
                                                                   device=self.device)
        return {"audio_codes": self._encoder.encode(wavs, sample_rate)}

    def _encode_v1(self, wavs: List[np.ndarray], sample_rate: int) -> dict:
        """Whisper-VQ codes, reference mels and CAM++ x-vectors of 16 kHz
        waveforms. The encoder is read at the first call; a directory without
        its tensors raises ``KeyError``."""
        if self._encoder is None:
            with open(os.path.join(self.model_dir, "config.json"), encoding="utf-8") as f:
                enc_cfg = wvq.WhisperVQConfig.from_dict(json.load(f).get("encoder_config"))
            st = MultiSafeTensors(self.model_dir)
            try:
                self._encoder = (enc_cfg, wvq.load_whisper_vq(st, enc_cfg, self.device))
            finally:
                st.close()
        enc_cfg, enc_params = self._encoder
        wavs16 = [audio.resample(np.asarray(w, np.float32), sample_rate, wvq.SAMPLE_RATE)
                  for w in wavs]
        codes = wvq.encode_waveforms(enc_params, enc_cfg, wavs16)
        ref_mels = [wvq.v1_ref_mel(w) for w in wavs16]
        if self._xvector is None:
            self._xvector = CampplusXVector.maybe_from_dir(self.model_dir, self.device) or False
        xvectors = [self._xvector.extract(w) for w in wavs16] if self._xvector else None
        return {"audio_codes": codes, "ref_mels": ref_mels, "xvectors": xvectors}

    def decode(self, encoded, *, seed: int = 0) -> Tuple[List[np.ndarray], int]:
        """Codes → (waveforms, output rate). ``encoded`` is ``encode``'s
        output or any dict of lists (``audio_codes``; 25 Hz also
        ``xvectors`` and ``ref_mels``), or a list of dicts of one clip each.
        ``seed`` seeds the 25 Hz decoder's initial noise (on the device)."""
        if isinstance(encoded, list):
            audio_codes = [np.asarray(e["audio_codes"]) for e in encoded]
            xvectors = ([np.asarray(e["xvectors"]) for e in encoded]
                        if "xvectors" in encoded[0] else None)
            ref_mels = ([np.asarray(e["ref_mels"]) for e in encoded]
                        if "ref_mels" in encoded[0] else None)
        elif isinstance(encoded, dict):
            audio_codes = [np.asarray(c) for c in encoded["audio_codes"]]
            xvectors = ([np.asarray(x) for x in encoded["xvectors"]]
                        if encoded.get("xvectors") is not None else None)
            ref_mels = ([np.asarray(m) for m in encoded["ref_mels"]]
                        if encoded.get("ref_mels") is not None else None)
        else:
            raise TypeError("encoded must be a dict or list of dicts")
        if self.model_type == MODEL_TYPE_25HZ:
            return self._decode_v1(audio_codes, xvectors, ref_mels, seed)
        return self._decode_v2(audio_codes)

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

    def batch_v1(self, codes_list, xvectors, ref_mels):
        """(lengths, codes [B, T] padded with -1, x-vectors [B, D], reference
        mels [B, T_mel, mel] padded with zeros), host numpy."""
        if xvectors is None or ref_mels is None:
            raise ValueError("25Hz decode requires `xvectors` and `ref_mels`")
        flat = [np.asarray(c).reshape(-1) for c in codes_list]
        lengths = [c.shape[0] for c in flat]
        codes = np.full((len(flat), max(lengths)), -1, np.int64)
        for i, c in enumerate(flat):
            codes[i, : lengths[i]] = c
        xv = np.stack([np.asarray(x, np.float32).reshape(-1) for x in xvectors])
        mel = np.zeros((len(ref_mels), max(m.shape[0] for m in ref_mels),
                        ref_mels[0].shape[-1]), np.float32)
        for i, m in enumerate(ref_mels):
            mel[i, : m.shape[0]] = m
        return lengths, codes, xv, mel

    def _decode_v1(self, codes_list, xvectors, ref_mels, seed: int
                   ) -> Tuple[List[np.ndarray], int]:
        """The clips batched (``batch_v1``), ``codec_v1_decode`` with its
        initial noise drawn by a generator on the device seeded by ``seed``
        (a code above ``num_embeds`` raises ``ValueError`` there), each row
        cut at its codes' samples."""
        lengths, codes, xv, mel = self.batch_v1(codes_list, xvectors, ref_mels)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        wav = codec_v1.codec_v1_decode(self.params, self.cfg, codes, xv, mel, generator)
        wav = wav.cpu().numpy()
        up = self.cfg.samples_per_code
        return [wav[i, : n * up] for i, n in enumerate(lengths)], self.cfg.output_sample_rate
