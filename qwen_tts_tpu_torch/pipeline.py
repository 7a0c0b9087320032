"""User-facing API (PyTorch counterpart of ``qwen_tts_tpu/pipeline.py``):
``Qwen3TTSModel.from_pretrained`` → ``generate_custom_voice`` /
``generate_voice_design`` / ``stream_custom_voice``, optionally after
``quantize_for_serving``.

Tokenize → build dual-track prompts → prefill + decode loop → per-row EOS
trim → chunked codec decode → waveforms. Streaming yields audio chunks as the
decode loop's segments finish. The model runs on one device, CUDA unless
``from_pretrained`` is given another; ``codec_dtype=torch.bfloat16`` runs the
codec in bf16, its narrow vocoder blocks as fused kernels.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch.config import TTSConfig
from qwen_tts_tpu_torch.generate import (
    GenerationParams,
    Prompt,
    batch_prompts,
    build_prompt,
    decode_segment,
    generate_codes,
    init_decode,
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


def _first_packet_program(
    talker_params: dict, st_params: dict, codec_params: dict, talker_cfg, dec_cfg,
    embeds: torch.Tensor, mask: torch.Tensor, trailing: torch.Tensor, *,
    sampling, st_sampling, max_cache_len: int, generator: Optional[torch.Generator],
    first_segment: int, step_limit: int, kv_int8: bool = False,
):
    """Prefill + the first decode segment + the codec decode of its frames:
    request to first audio. The JAX package fuses these into one device
    program; eager PyTorch runs them in turn. Returns (state, codes
    [B, first_segment, G], waveform [B, first_segment * upsample])."""
    state, seg = init_decode(
        talker_params, talker_cfg, embeds, mask, sampling=sampling,
        max_cache_len=max_cache_len, generator=generator, kv_int8=kv_int8,
        st_params=st_params, st_sampling=st_sampling, first_segment=first_segment,
        trailing=trailing, step_limit=step_limit)
    window = seg[:, :first_segment, : dec_cfg.num_quantizers].clamp(min=0)
    return state, seg, codec_mod.codec_decode(codec_params, dec_cfg, window)


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
        The trunk is kept only as that kernel's pack (``trunk_packed``).
        ``talker=True`` also makes the talker trunk int8; ``kv=True`` keeps the
        talker KV cache as int8 dicts (per-token, per-head f32 scales). Greedy
        codes are no longer those of the float model: a serving mode, not
        the parity default."""
        st = dict(self.subtalker_params)
        st["trunk_packed"] = pack_subtalker_weights(quantize_trunk_int8(st.pop("trunk")))
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

    def decode_codes(self, codes_list: Sequence[np.ndarray], *,
                     bucket: Optional[int] = None) -> List[np.ndarray]:
        """[T_i, G] codes → waveforms, batched with -1 padding (the codec is
        causal, so right padding never changes the kept region) and trimmed to
        each true length. ``bucket`` rounds the padded length up to a
        multiple, which bounds the number of distinct codec shapes."""
        if self.codec_params is None:
            raise RuntimeError("codec decoder weights not loaded")
        dec_cfg = self.cfg.codec.decoder
        nq = dec_cfg.num_quantizers
        lengths = [c.shape[0] for c in codes_list]
        if not lengths or max(lengths) == 0:
            return [np.zeros((0,), np.float32) for _ in codes_list]
        t_max = max(lengths)
        if bucket:
            t_max = -(-t_max // bucket) * bucket
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

    def stream_custom_voice(
        self,
        text: str,
        speaker: Optional[str] = None,
        language: str = "auto",
        *,
        first_chunk_frames: int = 2,
        chunk_frames: int = 25,
        left_context_frames: int = 25,
        **kwargs,
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Generator yielding (wav_chunk, sample_rate) as frames are decoded:
        a small first segment for a low first-packet latency, then segments
        of ``chunk_frames``. Each segment's codes go through the codec with
        ``left_context_frames`` of re-decoded context. The KV cache and the
        decode state stay on the device between segments."""
        params = self._merge_params(**kwargs)
        ids = self._tokenize(self.build_assistant_text(text))
        prompt = build_prompt(self.talker_params, self.cfg, ids, language=language,
                              speaker=speaker)
        yield from self.stream_from_prompt(
            prompt, params, first_chunk_frames=first_chunk_frames,
            chunk_frames=chunk_frames, left_context_frames=left_context_frames)

    def stream_from_prompt(
        self,
        prompt: Prompt,
        params: GenerationParams,
        *,
        first_chunk_frames: int = 2,
        chunk_frames: int = 25,
        left_context_frames: int = 25,
        ref_codes: Optional[np.ndarray] = None,
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Stream one prompt. ``ref_codes`` (a voice-clone reference) seed
        the codec's code history as frames already emitted: they condition
        the left context of every chunk, but their audio is never emitted.

        Every codec window after the first packet has the fixed shape
        ``left_context_frames + chunk_frames``, right-padded with code 0: the
        codec is causal, so the padding never reaches the emitted region. The
        EOS flags are read only where the stream may end (budget reached or
        no new frame). A stream that runs out of budget drops its final
        frame, as ``generate_codes`` does, so the stream's codes equal the
        one-shot codes."""
        if self.codec_params is None:
            raise RuntimeError("codec decoder weights not loaded")
        dec_cfg = self.cfg.codec.decoder
        nq = dec_cfg.num_quantizers
        up = self.cfg.codec.decode_upsample_rate
        dtype = self.talker_params["norm"].dtype

        embeds, mask, trailing, _ = batch_prompts([prompt], bucket=16)
        trailing = trailing.to(dtype)
        first_segment = min(first_chunk_frames, params.max_new_tokens)
        state, seg_codes, first_wav = _first_packet_program(
            self.talker_params, self.subtalker_params, self.codec_params,
            self.cfg.talker, dec_cfg, embeds.to(dtype), mask, trailing,
            sampling=params.talker_sampling(), st_sampling=params.subtalker_sampling(),
            max_cache_len=embeds.shape[1] + params.max_new_tokens,
            generator=torch.Generator(device=self.device).manual_seed(params.seed),
            first_segment=first_segment, step_limit=params.max_new_tokens,
            kv_int8=self.kv_int8,
        )

        if ref_codes is not None:
            history = np.asarray(ref_codes, np.int64)[:, :nq]
        else:
            history = np.zeros((0, nq), np.int64)
        ref_frames = history.shape[0]
        emitted = ref_frames
        prev_gen = 0
        first = True
        while True:
            new_gen = int(state.num_gen[0])
            seg_h = seg_codes.cpu().numpy()
            fresh = new_gen - prev_gen
            hit_budget = new_gen >= params.max_new_tokens
            stopped = bool(state.eos.all()) if (hit_budget or fresh <= 0) else False
            done = fresh <= 0 or stopped or hit_budget
            emit = fresh
            if done and hit_budget and not stopped:
                emit -= 1  # the budget-exhausted final frame, as in generate_codes
            if emit > 0:
                history = np.concatenate([history, seg_h[0, :fresh, :nq]], axis=0)
                if first and ref_frames == 0:
                    wav = first_wav[0, : emit * up].cpu().numpy()
                else:
                    ctx = min(left_context_frames, emitted)
                    window = np.zeros((1, left_context_frames + chunk_frames, nq), np.int64)
                    window[0, : ctx + emit] = history[emitted - ctx : emitted + emit]
                    wav = codec_mod.codec_decode(
                        self.codec_params, dec_cfg, torch.as_tensor(window, device=self.device)
                    )[0, ctx * up : (ctx + emit) * up].cpu().numpy()
                emitted += emit
                prev_gen = new_gen
                yield wav, self.sample_rate
            if done:
                break
            first = False
            state, seg_codes = decode_segment(
                self.talker_params, self.subtalker_params, self.cfg.talker, state, trailing,
                sampling=params.talker_sampling(), st_sampling=params.subtalker_sampling(),
                segment=chunk_frames, step_limit=params.max_new_tokens)

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
