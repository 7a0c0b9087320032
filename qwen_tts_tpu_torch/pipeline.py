"""User-facing API (PyTorch counterpart of ``qwen_tts_tpu/pipeline.py``):
``Qwen3TTSModel.from_pretrained`` → ``generate_custom_voice`` /
``generate_voice_design`` / ``stream_custom_voice``, and on Base checkpoints
``create_voice_clone_prompt`` → ``generate_voice_clone`` (voice files through
``save_voice_clone_prompt`` / ``load_voice_clone_prompt``), optionally after
``quantize_for_serving``.

Tokenize → build dual-track prompts → prefill + decode loop → per-row EOS
trim → chunked codec decode → waveforms. Streaming yields audio chunks as the
decode loop's segments finish. The model runs on one device, CUDA unless
``from_pretrained`` is given another; ``codec_dtype=torch.bfloat16`` runs the
codec in bf16, its narrow vocoder blocks as fused kernels. On the card the
decode loop replays a captured frame (``generate.py``), and a stream's first
packet and its later codec windows are CUDA graphs as well (``graphs.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch import voice_prompt
from qwen_tts_tpu_torch.audio import normalize_audio_inputs, resample
from qwen_tts_tpu_torch.codec_encoder import SpeechTokenizerEncoder
from qwen_tts_tpu_torch.config import TTSConfig
from qwen_tts_tpu_torch.generate import (
    GenerationParams,
    Prompt,
    _decode_eager,
    _prefill,
    _row_limit,
    batch_prompts,
    buffer_like,
    build_prompt,
    clone_state,
    decode_segment,
    fill_trailing,
    generate_codes,
    icl_ref_codes,
    trailing_rows,
)
from qwen_tts_tpu_torch.io.loader import load_checkpoint
from qwen_tts_tpu_torch.models import codec as codec_mod
from qwen_tts_tpu_torch.models.speaker import mel_spectrogram, speaker_encoder_forward
from qwen_tts_tpu_torch.models.subtalker import quantize_subtalker_tables_int8, st_env_token
from qwen_tts_tpu_torch.models.trunk import quantize_trunk_int8
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import pack_subtalker_weights
from qwen_tts_tpu_torch.utils import Device, resolve_device

MaybeList = Union[str, List[str]]

_HARD_DEFAULTS = dict(
    do_sample=True, top_k=50, top_p=1.0, temperature=0.9,
    repetition_penalty=1.05, subtalker_dosample=True, subtalker_top_k=50,
    subtalker_top_p=1.0, subtalker_temperature=0.9, max_new_tokens=2048,
)


def _first_packet_eager(
    talker_params: dict, st_params: dict, codec_params: dict, talker_cfg, dec_cfg,
    embeds: torch.Tensor, mask: torch.Tensor, trailing: torch.Tensor, *,
    sampling, st_sampling, max_cache_len: int, generator: Optional[torch.Generator],
    first_segment: int, step_limit: Union[int, torch.Tensor], kv_int8: bool = False,
    check: bool = True,
):
    """``_first_packet_program`` with each op run as it comes: the prefill,
    the first frames (``check``: as ``_frame_loop`` reads its flag) and the
    codec decode of their window, in turn."""
    state = _prefill(talker_params, talker_cfg, embeds, mask, sampling=sampling,
                     max_cache_len=max_cache_len, generator=generator, kv_int8=kv_int8)
    limit = _row_limit(step_limit, embeds.shape[0], embeds.device)
    state, seg = _decode_eager(talker_params, st_params, talker_cfg, sampling, st_sampling,
                               state, trailing, limit, first_segment, check=check)
    window = seg[:, :first_segment, : dec_cfg.num_quantizers].clamp(min=0)
    return state, seg, codec_mod.codec_decode(codec_params, dec_cfg, window)


def _first_packet_program(
    talker_params: dict, st_params: dict, codec_params: dict, talker_cfg, dec_cfg,
    embeds: torch.Tensor, mask: torch.Tensor, trailing: torch.Tensor, *,
    sampling, st_sampling, max_cache_len: int, generator: Optional[torch.Generator],
    first_segment: int, step_limit: int, kv_int8: bool = False,
):
    """Prefill + the first decode segment + the codec decode of its frames:
    request to first audio. Returns (state, codes [B, first_segment, G],
    waveform [B, first_segment * upsample]). On the card all of it is one
    CUDA graph replay (``_FirstPacketGraph``), as the JAX package runs it as
    one device program; on the CPU it runs eagerly."""
    kw = dict(sampling=sampling, st_sampling=st_sampling, max_cache_len=max_cache_len,
              first_segment=first_segment, kv_int8=kv_int8)
    if not embeds.is_cuda:
        return _first_packet_eager(talker_params, st_params, codec_params, talker_cfg, dec_cfg,
                                   embeds, mask, trailing, generator=generator,
                                   step_limit=step_limit, **kw)
    program = graphs.cached(
        first_packet_key(embeds, trailing, talker_cfg, dec_cfg, **kw),
        (talker_params, st_params, codec_params), lambda: (
            _FirstPacketGraph(talker_params, st_params, codec_params, talker_cfg, dec_cfg,
                              embeds, mask, trailing, step_limit, trailing_rows(trailing),
                              **kw)))
    return program.run(embeds, mask, trailing, step_limit, generator)


def first_packet_key(embeds: torch.Tensor, trailing: torch.Tensor, talker_cfg, dec_cfg,
                     **kw) -> tuple:
    """The key of the first-packet program: the prompt and trailing buckets,
    dtypes, configs, ``_first_packet_program``'s keywords and the
    sub-talker's gates."""
    return ("first_packet", embeds.device, tuple(embeds.shape), embeds.dtype,
            trailing_rows(trailing), trailing.dtype, talker_cfg, dec_cfg,
            tuple(sorted(kw.items())), st_env_token())


class _FirstPacketGraph:
    """``_first_packet_eager`` (without the flag read: its frames all run)
    captured as one CUDA graph for one prompt bucket, trailing bucket,
    ``first_segment``, ``max_cache_len``, dtypes, ``kv_int8``, sampling
    configs and sub-talker gates (``first_packet_key``). The prompt goes
    into its static inputs before each replay; its outputs are copied out
    after it."""

    def __init__(self, talker_params, st_params, codec_params, talker_cfg, dec_cfg,
                 embeds, mask, trailing, step_limit, rows, **kw):
        b, _, d = embeds.shape
        device = embeds.device
        self.embeds = buffer_like(embeds)
        self.mask = buffer_like(mask)
        self.trailing = torch.empty((b, rows, d), dtype=trailing.dtype, device=device)
        self.limit = torch.empty(b, dtype=torch.int32, device=device)
        generator = (torch.Generator(device=device)
                     if kw["sampling"].do_sample or kw["st_sampling"].do_sample else None)

        def program():
            return _first_packet_eager(
                talker_params, st_params, codec_params, talker_cfg, dec_cfg, self.embeds,
                self.mask, self.trailing, generator=generator, step_limit=self.limit,
                check=False, **kw)

        self._load(embeds, mask, trailing, step_limit)  # the warm-up run runs on it
        self.graph = graphs.Graph(program, generator)

    def _load(self, embeds, mask, trailing, step_limit) -> None:
        self.embeds.copy_(embeds)
        self.mask.copy_(mask)
        fill_trailing(self.trailing, trailing)
        self.limit.fill_(step_limit)

    def run(self, embeds, mask, trailing, step_limit, generator):
        with graphs.device_lock:
            self._load(embeds, mask, trailing, step_limit)
            with self.graph.drawing_from(generator):
                self.graph.replay()
            state, seg, wav = self.graph.outputs
            return (dataclasses.replace(clone_state(state), generator=generator), seg.clone(),
                    wav.clone())


def _codec_window(codec_params: dict, dec_cfg, window: torch.Tensor) -> torch.Tensor:
    """``codec_decode`` of one stream window [B, T, Q]: on the card a replay
    of a graph captured once per window shape (every window after the first
    packet has the same), on the CPU eager."""
    if not window.is_cuda:
        return codec_mod.codec_decode(codec_params, dec_cfg, window)
    key = ("codec_window", window.device, tuple(window.shape), window.dtype, dec_cfg)
    return graphs.cached(key, (codec_params,),
                         lambda: _CodecGraph(codec_params, dec_cfg, window)).run(window)


class _CodecGraph:
    """``codec_decode`` captured as one CUDA graph for one window shape."""

    def __init__(self, codec_params: dict, dec_cfg, window: torch.Tensor):
        self.window = window.clone()
        self.graph = graphs.Graph(
            lambda: codec_mod.codec_decode(codec_params, dec_cfg, self.window))

    def run(self, window: torch.Tensor) -> torch.Tensor:
        with graphs.device_lock:
            self.window.copy_(window)
            self.graph.replay()
            return self.graph.outputs.clone()


def load_text_tokenizer(model_dir: str):
    """The checkpoint's text tokenizer through ``transformers``, or None
    without ``transformers`` or tokenizer files (pre-tokenized ids still
    work)."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_dir)
    except (ImportError, OSError, ValueError):
        return None


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
        speaker_params: Optional[dict] = None,
    ):
        self.cfg = cfg
        self.talker_params = talker_params
        self.subtalker_params = subtalker_params
        self.codec_params = codec_params
        self.speaker_params = speaker_params
        self.tokenizer = tokenizer
        self.generate_defaults = generate_defaults or {}
        self.device = talker_params["norm"].device
        self.kv_int8 = False  # set by quantize_for_serving(kv=True)
        self.model_dir: Optional[str] = None
        self._speech_encoder: Optional[SpeechTokenizerEncoder] = None

    @property
    def speech_encoder(self) -> SpeechTokenizerEncoder:
        """The 12 Hz encode path (Mimi, float32 on the model's device), read
        from ``model_dir/speech_tokenizer`` at first use."""
        if self._speech_encoder is None:
            if self.model_dir is None:
                raise RuntimeError("no model_dir — load via from_pretrained")
            self._speech_encoder = SpeechTokenizerEncoder.from_pretrained(
                os.path.join(self.model_dir, "speech_tokenizer"), device=self.device)
        return self._speech_encoder

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
        cfg, talker, subtalker, codec, speaker = load_checkpoint(
            model_dir, talker_dtype=talker_dtype, codec_dtype=codec_dtype,
            device=resolve_device(device))
        tokenizer = load_text_tokenizer(model_dir) if load_tokenizer else None
        gen_defaults: Dict[str, Any] = {}
        gc_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gc_path):
            with open(gc_path, encoding="utf-8") as f:
                gen_defaults = json.load(f)
        obj = cls(cfg, talker, subtalker, codec, tokenizer, gen_defaults,
                  speaker_params=speaker)
        obj.model_dir = model_dir
        return obj

    def quantize_for_serving(self, *, talker: bool = False,
                             kv: bool = False) -> "Qwen3TTSModel":
        """int8 serving mode, in place; returns self. The sub-talker trunk,
        its stacked tables and its LM heads always go int8 (per-channel bf16
        scales); each micro-step then runs as one ``subtalker_step`` launch.
        The trunk is kept only as that kernel's pack (``trunk_packed``); the
        routes that run it layer by layer (the sub-talker int8 KV cache, the
        Jacobi micro-decode) untile it once, when they first run
        (``SubtalkerPack.trunk``). A trunk fused by ``fuse_trunk_params``
        packs to the bytes of its unfused one.
        ``talker=True`` also makes the talker trunk int8; ``kv=True`` keeps the
        talker KV cache as int8 dicts (per-token, per-head f32 scales). Greedy
        codes are no longer those of the float model: a serving mode, not
        the parity default. Drops the CUDA graphs captured on the trees it
        replaces."""
        graphs.drop(self.talker_params, self.subtalker_params)
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
    def build_ref_text(text: str) -> str:
        return f"<|im_start|>assistant\n{text}<|im_end|>\n"

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
        self, prompts: Sequence[Prompt], params: GenerationParams, *,
        trim_last_on_budget: bool = True,
        step_limit: Optional[Sequence[int]] = None,
        max_new_ceiling: Optional[int] = None,
        pad_batch_to: Optional[int] = None,
        trailing_bucket: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Run the decode loop; returns per-utterance [T_i, G] int32 codes and
        ``{"num_gen", "stopped"}``. ``trim_last_on_budget=False`` keeps the
        final frame of a row that ran out of budget (``generate_codes``).

        The keywords after it serve the window engine, whose windows vary in
        batch, budgets and trailing length, and each new shape is a new
        capture: ``max_new_ceiling`` sizes the cache and the program for that
        budget and ``step_limit`` gives each row its own (<= the ceiling);
        ``pad_batch_to`` pads the batch with copies of row 0 held to one
        frame (dropped on return); ``trailing_bucket`` rounds the trailing
        text's length (its pad rows are tts_pad, which a row takes past its
        text anyway)."""
        n_real = len(prompts)
        if pad_batch_to and pad_batch_to > n_real:
            prompts = list(prompts) + [prompts[0]] * (pad_batch_to - n_real)
            limits = (list(step_limit) if step_limit is not None
                      else [params.max_new_tokens] * n_real)
            step_limit = limits + [1] * (pad_batch_to - n_real)
        embeds, mask, trailing, _ = batch_prompts(prompts, trailing_bucket=trailing_bucket)
        dtype = self.talker_params["norm"].dtype
        generator = torch.Generator(device=self.device).manual_seed(params.seed)
        out = generate_codes(
            self.talker_params, self.subtalker_params, self.cfg.talker,
            embeds.to(dtype), mask, trailing.to(dtype),
            sampling=params.talker_sampling(),
            st_sampling=params.subtalker_sampling(),
            max_new_tokens=max_new_ceiling or params.max_new_tokens,
            generator=generator,
            trim_last_on_budget=trim_last_on_budget,
            step_limit=step_limit,
            kv_int8=self.kv_int8,
        )
        codes = out.codes[:n_real].cpu().numpy().astype(np.int32)
        num_gen = out.num_gen[:n_real].cpu().numpy()
        per_row = [codes[i, : num_gen[i]] for i in range(n_real)]
        return per_row, {"num_gen": num_gen, "stopped": out.stopped[:n_real].cpu().numpy()}

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

    def _request_prompts(
        self,
        texts: List[str],
        speakers: List[Optional[str]],
        languages: List[str],
        instructs: Optional[List[Optional[str]]] = None,
        speaker_embeds: Optional[List[Optional[np.ndarray]]] = None,
        ref_ids: Optional[List[Optional[np.ndarray]]] = None,
        ref_codes: Optional[List[Optional[np.ndarray]]] = None,
        non_streaming: bool = False,
    ) -> Tuple[List[Prompt], Optional[List[Optional[np.ndarray]]]]:
        """A request's talker prompts, and its reference codes cut to the
        talker's groups (``icl_ref_codes``, the one place a request's codes
        are cut)."""
        if ref_codes is not None:
            groups = self.cfg.talker.num_code_groups
            ref_codes = [None if c is None else icl_ref_codes(c, groups) for c in ref_codes]
        prompts = []
        for i, text in enumerate(texts):
            ids = self._tokenize(self.build_assistant_text(text))
            instruct = instructs[i] if instructs else None
            instr_ids = (self._tokenize(self.build_instruct_text(instruct))
                         if instruct else None)
            prompts.append(build_prompt(
                self.talker_params, self.cfg, ids, language=languages[i],
                speaker=speakers[i],
                speaker_embed=None if speaker_embeds is None else speaker_embeds[i],
                instruct_ids=instr_ids, non_streaming=non_streaming,
                ref_ids=None if ref_ids is None else ref_ids[i],
                ref_codes=None if ref_codes is None else ref_codes[i],
                st_params=self.subtalker_params,
            ))
        return prompts, ref_codes

    def _generate(
        self,
        texts: List[str],
        speakers: List[Optional[str]],
        languages: List[str],
        instructs: Optional[List[Optional[str]]] = None,
        speaker_embeds: Optional[List[Optional[np.ndarray]]] = None,
        ref_ids: Optional[List[Optional[np.ndarray]]] = None,
        ref_codes: Optional[List[Optional[np.ndarray]]] = None,
        non_streaming: bool = False,
        **kwargs,
    ) -> Tuple[List[np.ndarray], int]:
        params = self._merge_params(**kwargs)
        prompts, ref_codes = self._request_prompts(
            texts, speakers, languages, instructs, speaker_embeds, ref_ids, ref_codes,
            non_streaming)
        codes, _ = self.generate_codes_from_prompts(prompts, params)
        if ref_codes is None:
            return self.decode_codes(codes), self.sample_rate
        # Voice clone: the reference codes lead the codec decode (its left
        # context), and their share of the waveform is cut after it.
        cut = [0 if rc is None else rc.shape[0] for rc in ref_codes]
        merged = [c if rc is None else np.concatenate([rc.astype(np.int32), c], axis=0)
                  for rc, c in zip(ref_codes, codes)]
        up = self.cfg.codec.decode_upsample_rate
        wavs = self.decode_codes(merged)
        return [w[n * up:] for w, n in zip(wavs, cut)], self.sample_rate

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

    def clone_prompt_inputs(
        self, voice_clone_prompt: Dict[str, Any], index: int = 0
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
        """One item of a voice-clone prompt dict → the ``(speaker_embed,
        ref_ids, ref_codes)`` that ``build_prompt`` takes; the reference
        text goes through ``build_ref_text``. ICL items give all three,
        x-vector-only items the x-vector alone."""
        p = voice_clone_prompt

        def col(name, default):
            v = p.get(name)
            if not v:
                return default
            if index >= len(v):
                raise ValueError(f"voice_clone_prompt[{name!r}] has {len(v)} item(s); "
                                 f"index {index} out of range")
            return v[index]

        spk = col("ref_spk_embedding", None)
        icl = col("icl_mode", True)
        use_spk = col("x_vector_only_mode", False) or icl
        speaker_embed = np.asarray(spk) if (use_spk and spk is not None) else None
        ref_code = col("ref_code", None)
        if icl and ref_code is not None:
            ref_ids = self._tokenize(self.build_ref_text(col("ref_text", None) or ""))
            return speaker_embed, ref_ids, np.asarray(ref_code, np.int32)
        return speaker_embed, None, None

    def _clone_request(
        self,
        text: MaybeList,
        voice_clone_prompt: Optional[Any] = None,
        language: MaybeList = "auto",
        non_streaming_mode: bool = False,
        *,
        ref_audio=None,
        ref_text: Optional[MaybeList] = None,
        x_vector_only_mode: bool = False,
    ) -> Dict[str, Any]:
        """``generate_voice_clone``'s request as ``_request_prompts`` /
        ``_generate`` take it: the prompt built or normalised, one item
        broadcast over every text."""
        if voice_clone_prompt is None:
            if ref_audio is None:
                raise ValueError("provide voice_clone_prompt, or ref_audio (+ref_text)")
            voice_clone_prompt = self.create_voice_clone_prompt(
                ref_audio, ref_text=ref_text, x_vector_only_mode=x_vector_only_mode)
        else:
            voice_clone_prompt = voice_prompt.normalize_voice_clone_prompt(
                voice_clone_prompt)
        texts = _as_list(text)
        languages = _broadcast(_as_list(language), len(texts))
        n = len(texts)
        n_items = max((len(v) for v in voice_clone_prompt.values() if v), default=0)
        if n_items == 1 and n > 1:
            voice_clone_prompt = {k: (list(v) * n if v else v)
                                  for k, v in voice_clone_prompt.items()}
        elif n_items not in (0, n):
            raise ValueError(
                f"voice_clone_prompt has {n_items} item(s) for {n} text(s) — "
                "pass one prompt item (broadcast) or exactly one per text")

        speaker_embeds, ref_ids, ref_codes = [], [], []
        for i in range(n):
            se, ri, rc = self.clone_prompt_inputs(voice_clone_prompt, i)
            speaker_embeds.append(se)
            ref_ids.append(ri)
            ref_codes.append(rc)
        any_icl = any(c is not None for c in ref_codes)
        return dict(texts=texts, speakers=[None] * n, languages=languages,
                    speaker_embeds=speaker_embeds, ref_ids=ref_ids if any_icl else None,
                    ref_codes=ref_codes if any_icl else None, non_streaming=non_streaming_mode)

    def generate_voice_clone(
        self,
        text: MaybeList,
        voice_clone_prompt: Optional[Any] = None,
        language: MaybeList = "auto",
        non_streaming_mode: bool = False,
        *,
        ref_audio=None,
        ref_text: Optional[MaybeList] = None,
        x_vector_only_mode: bool = False,
        **kwargs,
    ) -> Tuple[List[np.ndarray], int]:
        """Speak ``text`` in a cloned voice. ``voice_clone_prompt`` is the
        dict from ``create_voice_clone_prompt`` or ``load_voice_clone_prompt``,
        one prompt item (a dict or an object with the item's fields), or a
        list of items; or pass ``ref_audio`` (+ ``ref_text`` /
        ``x_vector_only_mode``) and the prompt is built here. One item
        broadcasts over every text; otherwise there must be one per text."""
        return self._generate(**self._clone_request(
            text, voice_clone_prompt, language, non_streaming_mode, ref_audio=ref_audio,
            ref_text=ref_text, x_vector_only_mode=x_vector_only_mode), **kwargs)

    def extract_speaker_embedding(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """A mono waveform at the speaker encoder's rate (24 kHz) → its
        x-vector [enc_dim], float32."""
        if self.speaker_params is None:
            raise RuntimeError("this checkpoint has no speaker encoder (not a Base model)")
        spk_cfg = self.cfg.speaker_encoder
        if sr != spk_cfg.sample_rate:
            raise ValueError(f"Only {spk_cfg.sample_rate} Hz audio supported")
        with torch.inference_mode():
            wav = torch.as_tensor(np.asarray(audio, np.float32)[None], device=self.device)
            mels = mel_spectrogram(wav, n_fft=1024, num_mels=spk_cfg.mel_dim,
                                   sampling_rate=sr, hop_size=256, win_size=1024, fmin=0,
                                   fmax=12000)
            xvec = speaker_encoder_forward(self.speaker_params, spk_cfg, mels)
        return xvec[0].cpu().numpy()

    def create_voice_clone_prompt(
        self,
        ref_audio,
        ref_text: Optional[MaybeList] = None,
        *,
        sample_rate: int = 24000,
        x_vector_only_mode: bool = False,
        icl_mode: bool = True,
    ) -> Dict[str, Any]:
        """A voice-clone prompt dict from reference audio: its codes from the
        12 Hz encoder (ICL mode) and its x-vector. ``ref_audio``: a WAV
        path, http(s) URL or base64 string, an ``(np.ndarray, sr)`` tuple, a
        bare ndarray at ``sample_rate``, or a list of those. Audio at another
        rate is resampled to 24 kHz first (``audio.resample``)."""
        raw = ref_audio if isinstance(ref_audio, list) else [ref_audio]
        if sample_rate is not None:
            raw = [(np.asarray(a, np.float32), sample_rate) if isinstance(a, np.ndarray)
                   else a for a in raw]
        audios = [resample(w, sr, 24000) for w, sr in normalize_audio_inputs(raw)]
        n = len(audios)
        ref_texts = _broadcast(_as_list(ref_text), n) if ref_text else [None] * n
        use_icl = icl_mode and not x_vector_only_mode
        ref_codes = self.speech_encoder.encode(audios, 24000) if use_icl else [None] * n
        spk = ([self.extract_speaker_embedding(a, 24000) for a in audios]
               if self.speaker_params is not None else [None] * n)
        return {
            "ref_code": ref_codes,
            "ref_spk_embedding": spk,
            "ref_text": ref_texts,
            "icl_mode": [use_icl] * n,
            "x_vector_only_mode": [not use_icl] * n,
        }

    @staticmethod
    def save_voice_clone_prompt(prompt: Dict[str, Any], path: str) -> str:
        """Write a voice-clone prompt as a reusable voice file: ``.npz``, or
        else the reference demo's torch payload (``.pt``)."""
        return voice_prompt.save_voice_clone_prompt(prompt, path)

    @staticmethod
    def load_voice_clone_prompt(path: str) -> Dict[str, Any]:
        """Read a voice file written by ``save_voice_clone_prompt``, by the
        JAX package or by the reference demo."""
        return voice_prompt.load_voice_clone_prompt(path)

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
                    wav = _codec_window(
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
