"""User-facing API (PyTorch counterpart of ``qwen_tts_tpu/pipeline.py``):
``Qwen3TTSModel.from_pretrained`` → ``generate_custom_voice`` /
``generate_voice_design``, optionally after ``quantize_for_serving``.

Tokenize → build dual-track prompts → prefill + decode loop → per-row EOS
trim → chunked codec decode → waveforms. The model runs on one device, CUDA
unless ``from_pretrained`` is given another.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch.config import TTSConfig
from qwen_tts_tpu_torch.generate import (
    GenerationParams,
    Prompt,
    batch_prompts,
    build_prompt,
    generate_codes,
)
from qwen_tts_tpu_torch.io.loader import load_checkpoint
from qwen_tts_tpu_torch.models import codec as codec_mod
from qwen_tts_tpu_torch.models.subtalker import quantize_subtalker_tables_int8
from qwen_tts_tpu_torch.models.trunk import quantize_trunk_int8
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import pack_subtalker_weights
from qwen_tts_tpu_torch.utils import Device, resolve_device

MaybeList = Union[str, List[str]]

_HARD_DEFAULTS = dict(
    do_sample=True, top_k=50, top_p=1.0, temperature=0.9,
    repetition_penalty=1.05, subtalker_dosample=True, subtalker_top_k=50,
    subtalker_top_p=1.0, subtalker_temperature=0.9, max_new_tokens=2048,
)


class Qwen3TTSModel:
    """Qwen3-TTS inference pipeline on one device."""

    def __init__(
        self,
        cfg: TTSConfig,
        talker_params: dict,
        subtalker_params: dict,
        codec_params: Optional[dict] = None,
        tokenizer=None,
        generate_defaults: Optional[Dict[str, Any]] = None,
    ):
        self.cfg = cfg
        self.talker_params = talker_params
        self.subtalker_params = subtalker_params
        self.codec_params = codec_params
        self.tokenizer = tokenizer
        self.generate_defaults = generate_defaults or {}
        self.device = talker_params["norm"].device
        self.kv_int8 = False  # set by quantize_for_serving(kv=True)

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        *,
        talker_dtype=torch.bfloat16,
        codec_dtype=torch.float32,
        device: Device = None,
        load_tokenizer: bool = True,
    ) -> "Qwen3TTSModel":
        """Load a checkpoint directory onto ``device`` (CUDA unless given).
        Without ``transformers`` or tokenizer files the tokenizer stays None;
        assign ``model.tokenizer`` to inject one."""
        cfg, talker, subtalker, codec = load_checkpoint(
            model_dir, talker_dtype=talker_dtype, codec_dtype=codec_dtype,
            device=resolve_device(device))
        tokenizer = None
        if load_tokenizer:
            try:
                from transformers import AutoTokenizer

                tokenizer = AutoTokenizer.from_pretrained(model_dir)
            except (ImportError, OSError, ValueError):
                tokenizer = None  # pre-tokenized prompts still work
        gen_defaults: Dict[str, Any] = {}
        gc_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gc_path):
            with open(gc_path, encoding="utf-8") as f:
                gen_defaults = json.load(f)
        return cls(cfg, talker, subtalker, codec, tokenizer, gen_defaults)

    def quantize_for_serving(self, *, talker: bool = False,
                             kv: bool = False) -> "Qwen3TTSModel":
        """int8 serving mode, in place; returns self. The sub-talker trunk,
        its stacked tables and its LM heads always go int8 (per-channel bf16
        scales); each micro-step then runs as one ``subtalker_step`` launch.
        ``talker=True`` also makes the talker trunk int8; ``kv=True`` keeps the
        talker KV cache as int8 dicts (per-token, per-head f32 scales). Greedy
        codes are no longer those of the float model: a serving mode, not
        the parity default."""
        st = dict(self.subtalker_params)
        st["trunk"] = quantize_trunk_int8(st["trunk"])
        st["trunk_packed"] = pack_subtalker_weights(st["trunk"])
        self.subtalker_params = quantize_subtalker_tables_int8(st)
        if talker:
            self.talker_params = dict(self.talker_params)
            self.talker_params["trunk"] = quantize_trunk_int8(self.talker_params["trunk"])
        if kv:
            self.kv_int8 = True
        return self

    def get_supported_speakers(self) -> List[str]:
        return [name for name, _ in self.cfg.talker.spk_id]

    def get_supported_languages(self) -> List[str]:
        langs = ["auto"]
        for name, _ in self.cfg.talker.codec_language_id:
            if "dialect" not in name:
                langs.append(name)
        return langs

    @property
    def sample_rate(self) -> int:
        return self.cfg.codec.output_sample_rate

    @staticmethod
    def build_assistant_text(text: str) -> str:
        return f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"

    @staticmethod
    def build_instruct_text(instruct: str) -> str:
        return f"<|im_start|>user\n{instruct}<|im_end|>\n"

    def _tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError(
                "No tokenizer loaded; set model.tokenizer or build prompts from ids"
            )
        return np.asarray(self.tokenizer(text)["input_ids"], np.int64)

    def _merge_params(self, **user) -> GenerationParams:
        """User kwargs over ``generation_config.json`` over the hard defaults.
        ``min_new_tokens`` is taken from the user only (default 2)."""
        def pick(name):
            v = user.get(name)
            if v is not None:
                return v
            if name in self.generate_defaults:
                return self.generate_defaults[name]
            return _HARD_DEFAULTS[name]

        min_new = user.get("min_new_tokens")
        return GenerationParams(
            max_new_tokens=pick("max_new_tokens"),
            do_sample=pick("do_sample"),
            top_k=pick("top_k"),
            top_p=pick("top_p"),
            temperature=pick("temperature"),
            repetition_penalty=pick("repetition_penalty"),
            min_new_tokens=GenerationParams.min_new_tokens if min_new is None else min_new,
            subtalker_do_sample=pick("subtalker_dosample"),
            subtalker_top_k=pick("subtalker_top_k"),
            subtalker_top_p=pick("subtalker_top_p"),
            subtalker_temperature=pick("subtalker_temperature"),
            seed=user.get("seed", 0) or 0,
        )

    def generate_codes_from_prompts(
        self, prompts: Sequence[Prompt], params: GenerationParams,
    ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Run the decode loop; returns per-utterance [T_i, G] int32 codes and
        ``{"num_gen", "stopped"}``."""
        embeds, mask, trailing, _ = batch_prompts(prompts)
        dtype = self.talker_params["norm"].dtype
        generator = torch.Generator(device=self.device).manual_seed(params.seed)
        out = generate_codes(
            self.talker_params, self.subtalker_params, self.cfg.talker,
            embeds.to(dtype), mask, trailing.to(dtype),
            sampling=params.talker_sampling(),
            st_sampling=params.subtalker_sampling(),
            max_new_tokens=params.max_new_tokens,
            generator=generator,
            kv_int8=self.kv_int8,
        )
        codes = out.codes.cpu().numpy().astype(np.int32)
        num_gen = out.num_gen.cpu().numpy()
        per_row = [codes[i, : num_gen[i]] for i in range(codes.shape[0])]
        return per_row, {"num_gen": num_gen, "stopped": out.stopped.cpu().numpy()}

    def decode_codes(self, codes_list: Sequence[np.ndarray]) -> List[np.ndarray]:
        """[T_i, G] codes → waveforms, batched with -1 padding (the codec is
        causal, so right padding never changes the kept region) and trimmed to
        each true length."""
        if self.codec_params is None:
            raise RuntimeError("codec decoder weights not loaded")
        dec_cfg = self.cfg.codec.decoder
        nq = dec_cfg.num_quantizers
        lengths = [c.shape[0] for c in codes_list]
        if not lengths or max(lengths) == 0:
            return [np.zeros((0,), np.float32) for _ in codes_list]
        t_max = max(lengths)
        batch = np.full((len(codes_list), t_max, nq), -1, np.int64)
        for i, c in enumerate(codes_list):
            batch[i, : c.shape[0]] = c[:, :nq]
        wav = codec_mod.chunked_decode(
            self.codec_params, dec_cfg, torch.as_tensor(batch, device=self.device))
        wav = wav.cpu().numpy()
        up = self.cfg.codec.decode_upsample_rate
        return [wav[i, : lengths[i] * up] for i in range(len(codes_list))]

    def _generate(
        self,
        texts: List[str],
        speakers: List[Optional[str]],
        languages: List[str],
        instructs: Optional[List[Optional[str]]] = None,
        non_streaming: bool = False,
        **kwargs,
    ) -> Tuple[List[np.ndarray], int]:
        params = self._merge_params(**kwargs)
        prompts = []
        for i, text in enumerate(texts):
            ids = self._tokenize(self.build_assistant_text(text))
            instruct = instructs[i] if instructs else None
            instr_ids = (self._tokenize(self.build_instruct_text(instruct))
                         if instruct else None)
            prompts.append(build_prompt(
                self.talker_params, self.cfg, ids, language=languages[i],
                speaker=speakers[i], instruct_ids=instr_ids,
                non_streaming=non_streaming,
            ))
        codes, _ = self.generate_codes_from_prompts(prompts, params)
        return self.decode_codes(codes), self.sample_rate

    def generate_custom_voice(
        self,
        text: MaybeList,
        speaker: MaybeList,
        language: MaybeList = "auto",
        instruct: Optional[MaybeList] = None,
        non_streaming_mode: bool = False,
        **kwargs,
    ) -> Tuple[List[np.ndarray], int]:
        """``non_streaming_mode`` feeds the whole text before codec_bos
        instead of trailing it in during decode."""
        texts = _as_list(text)
        speakers = _broadcast(_as_list(speaker), len(texts))
        languages = _broadcast(_as_list(language), len(texts))
        instructs = _broadcast(_as_list(instruct), len(texts)) if instruct else None
        if self.cfg.tts_model_size == "0.6b":
            instructs = None  # 0.6B drops instructions
        self._validate(speakers, languages)
        return self._generate(texts, speakers, languages, instructs,
                              non_streaming=non_streaming_mode, **kwargs)

    def generate_voice_design(
        self,
        text: MaybeList,
        instruct: MaybeList,
        language: MaybeList = "auto",
        non_streaming_mode: bool = False,
        **kwargs,
    ) -> Tuple[List[np.ndarray], int]:
        texts = _as_list(text)
        instructs = _broadcast(_as_list(instruct), len(texts))
        languages = _broadcast(_as_list(language), len(texts))
        speakers = [None] * len(texts)
        self._validate(speakers, languages)
        return self._generate(texts, speakers, languages, instructs,
                              non_streaming=non_streaming_mode, **kwargs)

    def _validate(self, speakers, languages):
        sup_l = set(self.get_supported_languages())
        for lang in languages:
            if lang and lang.lower() not in sup_l:
                raise NotImplementedError(f"Language {lang} not implemented")
        sup_s = set(self.get_supported_speakers())
        for spk in speakers:
            if spk and spk.lower() not in sup_s:
                raise NotImplementedError(f"Speaker {spk} not implemented")


def _as_list(x) -> List:
    return x if isinstance(x, list) else [x]


def _broadcast(xs: List, n: int) -> List:
    if len(xs) == 1 and n > 1:
        return xs * n
    if len(xs) != n:
        raise ValueError(f"length mismatch: {len(xs)} vs {n}")
    return xs
