"""End-to-end generation: the dual-track prompt and the autoregressive
decode loop (PyTorch counterpart of ``qwen_tts_tpu/generate.py``).

Every prompt position is the sum of a text-track embedding (projected) and a
codec-track embedding. The decode loop is a plain Python loop over frames:
each frame runs the sub-talker micro-decode, the group-embedding sum plus the
trailing text, the talker single-token step, logits processing and sampling.
EOS is tracked per row and the loop ends when every row has stopped or used
its frame budget. Streaming runs the same loop in resumable segments:
``init_decode(first_segment=...)`` right after the prefill, then
``decode_segment`` on the carried ``DecodeState``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch.config import TalkerConfig, TTSConfig
from qwen_tts_tpu_torch.models import subtalker as st_mod
from qwen_tts_tpu_torch.models import talker as talker_mod
from qwen_tts_tpu_torch.ops.attention import KVCache
from qwen_tts_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplingConfig,
    apply_repetition_penalty,
    apply_suppress_mask,
    build_suppress_mask,
    sample_token,
)


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """Generation controls; defaults mirror the reference's hard defaults."""

    max_new_tokens: int = 2048
    do_sample: bool = True
    top_k: int = 50
    top_p: float = 1.0
    temperature: float = 0.9
    repetition_penalty: float = 1.05
    min_new_tokens: int = 2
    subtalker_do_sample: bool = True
    subtalker_top_k: int = 50
    subtalker_top_p: float = 1.0
    subtalker_temperature: float = 0.9
    seed: int = 0

    def talker_sampling(self) -> SamplingConfig:
        return SamplingConfig(
            do_sample=self.do_sample,
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            repetition_penalty=self.repetition_penalty,
            min_new_tokens=self.min_new_tokens,
        )

    def subtalker_sampling(self) -> SamplingConfig:
        return SamplingConfig(
            do_sample=self.subtalker_do_sample,
            temperature=self.subtalker_temperature,
            top_k=self.subtalker_top_k,
            top_p=self.subtalker_top_p,
        )

    def greedy(self) -> "GenerationParams":
        return dataclasses.replace(
            self, do_sample=False, subtalker_do_sample=False,
            repetition_penalty=1.0, min_new_tokens=0,
        )


# --------------------------------------------------------------------------
# Prompt schema
# --------------------------------------------------------------------------

class Prompt(NamedTuple):
    """One utterance's prefix on both tracks (unbatched, on the model's device)."""

    embeds: torch.Tensor         # [S, D] summed dual-track prefix embeddings
    trailing_text: torch.Tensor  # [T_tr, D] trailing text-track embeddings
    tts_pad_embed: torch.Tensor  # [D]


def build_prompt(
    params: dict,
    cfg: TTSConfig,
    text_ids: Sequence[int],
    *,
    language: str = "auto",
    speaker: Optional[str] = None,
    instruct_ids: Optional[Sequence[int]] = None,
    non_streaming: bool = False,
) -> Prompt:
    """Build the dual-track prefix for one utterance.

    ``text_ids`` is the full chat-templated id sequence
    ``[im_start, assistant, \\n, TEXT..., im_end, \\n, im_start, assistant, \\n]``:
    positions [0:3] are the role header, [3:-5] the content."""
    tk = cfg.talker
    text_ids = np.asarray(text_ids, np.int64)
    if text_ids.ndim != 1 or text_ids.shape[0] < 8:
        raise ValueError("need the full chat-templated id sequence (>= 8 ids)")
    device = params["codec_embedding"].device

    def ids_t(ids) -> torch.Tensor:
        return torch.as_tensor(np.atleast_1d(np.asarray(ids, np.int64)), device=device)

    def etext(ids) -> torch.Tensor:
        return talker_mod.embed_text(params, ids_t(ids))

    def ecodec(ids) -> torch.Tensor:
        return talker_mod.embed_codec(params, ids_t(ids))

    tts_bos, tts_eos, tts_pad = etext(
        [cfg.tts_bos_token_id, cfg.tts_eos_token_id, cfg.tts_pad_token_id])

    # Speaker slot.
    spk_vec: Optional[torch.Tensor] = None
    if speaker:
        sid = tk.speaker_codec_id(speaker)
        if sid is None:
            raise ValueError(f"Speaker {speaker!r} not supported")
        spk_vec = ecodec([sid])[0]

    # Language id, with the dialect override.
    language = (language or "auto").lower()
    if language == "auto":
        language_id = None
    else:
        language_id = tk.language_codec_id(language)
        if language_id is None:
            raise ValueError(f"Language {language!r} not supported")
    if language in ("chinese", "auto") and speaker:
        dialect = tk.speaker_dialect(speaker)
        if dialect:
            language_id = tk.language_codec_id(dialect)

    # Codec-track prefix.
    if language_id is None:
        codec_ids = [tk.codec_nothink_id, tk.codec_think_bos_id, tk.codec_think_eos_id]
    else:
        codec_ids = [tk.codec_think_id, tk.codec_think_bos_id, language_id,
                     tk.codec_think_eos_id]
    codec_embeds = [ecodec(codec_ids)]
    if spk_vec is not None:
        codec_embeds.append(spk_vec[None])
    codec_embeds.append(ecodec([tk.codec_pad_id, tk.codec_bos_id]))
    codec_prefix = torch.cat(codec_embeds, dim=0)  # [n_codec, D]
    n_codec = codec_prefix.shape[0]

    pieces: List[torch.Tensor] = []
    if instruct_ids is not None and len(instruct_ids) > 0:
        pieces.append(etext(instruct_ids))

    # Role header (3 tokens, text track only).
    pieces.append(etext(text_ids[:3]))

    # tts_pad × (n_codec - 2) + tts_bos on the text track, summed with the
    # codec prefix without its last token (codec_bos).
    text_track = torch.cat([tts_pad[None].expand(n_codec - 2, -1), tts_bos[None]], dim=0)
    pieces.append(text_track + codec_prefix[:-1])

    if non_streaming:
        # Whole text + tts_eos on the text track, each summed with codec_pad;
        # then tts_pad + codec_bos.
        content = etext(text_ids[3:-5])
        codec_pad = ecodec([tk.codec_pad_id])[0]
        block = torch.cat([content, tts_eos[None]], dim=0) + codec_pad[None]
        pieces.append(block)
        pieces.append((tts_pad + codec_prefix[-1])[None])
        trailing = tts_pad[None]
    else:
        # First content token + codec_bos; the rest of the text trails in
        # during decode.
        pieces.append(etext(text_ids[3:4]) + codec_prefix[-1:])
        trailing = torch.cat([etext(text_ids[4:-5]), tts_eos[None]], dim=0)
    return Prompt(torch.cat(pieces, dim=0), trailing, tts_pad)


def batch_prompts(
    prompts: Sequence[Prompt], bucket: int = 32,
    trailing_bucket: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]:
    """Left-pad prompts into a batch.

    Returns (embeds [B,S,D], pad_mask [B,S], trailing [B,T+1,D], lengths [B]).
    S is rounded up to ``bucket``; trailing pad rows are tts_pad, which is what
    the decode consumes past each row's text."""
    lengths = np.array([p.embeds.shape[0] for p in prompts])
    s = int(np.ceil(lengths.max() / bucket) * bucket)
    first = prompts[0].embeds
    b, d = len(prompts), first.shape[1]
    embeds = torch.zeros((b, s, d), dtype=first.dtype, device=first.device)
    mask = torch.zeros((b, s), dtype=torch.bool, device=first.device)
    for i, p in enumerate(prompts):
        n = p.embeds.shape[0]
        embeds[i, s - n :] = p.embeds
        mask[i, s - n :] = True

    t_max = max(p.trailing_text.shape[0] for p in prompts)
    if trailing_bucket:
        t_max = -(-t_max // trailing_bucket) * trailing_bucket
    trailing = torch.zeros((b, t_max + 1, d), dtype=first.dtype, device=first.device)
    for i, p in enumerate(prompts):
        n = p.trailing_text.shape[0]
        trailing[i, :n] = p.trailing_text
        trailing[i, n:] = p.tts_pad_embed
    return embeds, mask, trailing, lengths


# --------------------------------------------------------------------------
# Decode loop
# --------------------------------------------------------------------------

class GenOutput(NamedTuple):
    codes: torch.Tensor    # [B, max_new, G] int64
    num_gen: torch.Tensor  # [B] frames generated before EOS
    stopped: torch.Tensor  # [B] bool — True if EOS was seen


@dataclasses.dataclass
class DecodeState:
    """Decode-loop state, updated frame by frame. Per-row fields are
    independent: cache positions derive from ``prefix_len + num_gen``."""

    token: torch.Tensor       # [B] current codebook-0 token
    hidden: torch.Tensor      # [B, D] talker post-norm hidden
    k_cache: KVCache          # [L, B, S_max, KV, hd] (tensor or int8 dict)
    v_cache: KVCache
    presence: torch.Tensor    # [B, V] repetition-penalty history
    eos: torch.Tensor         # [B] bool
    num_gen: torch.Tensor     # [B] int32 per-row frames generated
    prefix_len: torch.Tensor  # [B] int32 prefill length
    n_real: torch.Tensor      # [B] int32 unpadded prefix lengths
    valid_from: torch.Tensor  # [B] int32 left-pad counts
    generator: Optional[torch.Generator] = None  # sampling draws, carried across segments


def _processor(talker_cfg: TalkerConfig, sampling: SamplingConfig, device):
    """Logits pipeline: suppress → min-new-tokens EOS ban → repetition
    penalty → sample."""
    vocab = talker_cfg.vocab_size
    eos_id = talker_cfg.codec_eos_token_id
    suppress = build_suppress_mask(vocab, eos_id, tail=talker_cfg.suppress_tail,
                                   device=device)
    is_eos = torch.arange(vocab, device=device) == eos_id

    def process_and_sample(logits, presence, num_sampled, generator):
        logits = apply_suppress_mask(logits, suppress[None])
        if sampling.min_new_tokens > 0:
            ban = num_sampled < sampling.min_new_tokens  # [B]
            logits = logits.masked_fill(ban[:, None] & is_eos[None], NEG_INF)
        logits = apply_repetition_penalty(logits, presence, sampling.repetition_penalty)
        return sample_token(logits, sampling, generator)

    return process_and_sample


def init_decode(
    talker_params: dict,
    talker_cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D] left-padded prefix
    pad_mask: torch.Tensor,       # [B, S]
    *,
    sampling: SamplingConfig,
    max_cache_len: int,
    generator: Optional[torch.Generator],
    kv_int8: bool = False,
    st_params: Optional[dict] = None,
    st_sampling: Optional[SamplingConfig] = None,
    first_segment: int = 0,
    trailing: Optional[torch.Tensor] = None,
    step_limit: Optional[Union[int, Sequence[int], torch.Tensor]] = None,
) -> Union[DecodeState, Tuple[DecodeState, torch.Tensor]]:
    """Prefill + first-token sample; returns the decode state. ``kv_int8``
    keeps the talker KV cache as int8 dicts.

    With ``first_segment > 0`` (needs ``st_params``, ``st_sampling`` and
    ``trailing``) the first frames run right after the prefill, and the
    result is ``(state, codes [B, first_segment, G])``, as from
    ``decode_segment``. ``step_limit`` (int or per row) caps each row's
    frames; it defaults to ``first_segment``."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    k_cache, v_cache = talker_mod.alloc_kv_cache(
        talker_cfg, b, max_cache_len, talker_params["norm"].dtype, device, kv_int8=kv_int8)
    pre = talker_mod.talker_prefill(
        talker_params, talker_cfg, inputs_embeds, pad_mask, k_cache, v_cache)
    n_real = pad_mask.int().sum(dim=-1, dtype=torch.int32)
    presence = torch.zeros((b, talker_cfg.vocab_size), dtype=torch.bool, device=device)
    zeros = torch.zeros(b, dtype=torch.int32, device=device)
    token0 = _processor(talker_cfg, sampling, device)(pre.logits, presence, zeros, generator)
    presence[torch.arange(b, device=device), token0] = True
    state = DecodeState(
        token=token0, hidden=pre.last_hidden, k_cache=pre.k_cache, v_cache=pre.v_cache,
        presence=presence, eos=token0 == talker_cfg.codec_eos_token_id, num_gen=zeros,
        prefix_len=torch.full((b,), s, dtype=torch.int32, device=device),
        n_real=n_real, valid_from=s - n_real, generator=generator,
    )
    if first_segment <= 0:
        return state
    limit = _row_limit(first_segment if step_limit is None else step_limit, b, device)
    body = _frame_body(talker_params, st_params, talker_cfg, sampling, st_sampling,
                       trailing, limit, generator)
    return _segment_loop(body, state, first_segment, limit, talker_cfg.num_code_groups)


def _row_limit(step_limit: Union[int, Sequence[int], torch.Tensor], b: int,
               device) -> torch.Tensor:
    """A frame budget (int or per row) as an int32 [B] tensor."""
    return torch.as_tensor(step_limit, dtype=torch.int32, device=device).expand(b)


def _frame_body(
    talker_params: dict,
    st_params: dict,
    talker_cfg: TalkerConfig,
    sampling: SamplingConfig,
    st_sampling: SamplingConfig,
    trailing: torch.Tensor,
    step_limit: torch.Tensor,  # [B] per-row frame budget
    generator: Optional[torch.Generator],
):
    """One frame of the AR loop: sub-talker → Σ-embed + trailing → talker
    step → sample. Positions are per row (from ``num_gen``)."""
    eos_id = talker_cfg.codec_eos_token_id
    trailing_max = trailing.shape[1] - 1
    process_and_sample = _processor(talker_cfg, sampling, trailing.device)
    dtype = talker_params["norm"].dtype
    rows = torch.arange(trailing.shape[0], device=trailing.device)

    def body(st: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
        active = ~st.eos & (st.num_gen < step_limit)

        # 1) the sub-talker expands the current token into all groups.
        frame = st_mod.subtalker_generate(
            st_params, talker_cfg.code_predictor, talker_params["codec_embedding"],
            st.hidden, st.token, st_sampling, generator,
        )  # [B, G]
        num_gen = st.num_gen + active.int()

        # 2) next talker input: Σ group embeddings + trailing text / tts_pad.
        emb = st_mod.embed_groups_sum(st_params, talker_params["codec_embedding"], frame)
        emb = emb + trailing[rows, st.num_gen.clamp(max=trailing_max).long()]

        # 3) talker step at each row's own cache and rope position. Inactive
        #    rows rewrite their current slot (masked out, harmless).
        logits, hidden, kc, vc = talker_mod.talker_decode_step(
            talker_params, talker_cfg, emb.to(dtype), st.n_real + st.num_gen,
            st.k_cache, st.v_cache, st.prefix_len + st.num_gen + 1, st.valid_from,
        )

        # 4) sample the next codebook-0 token.
        token = process_and_sample(logits, st.presence, st.num_gen + 1, generator)
        token = torch.where(active, token, st.token)
        st.presence[rows, token] = True
        new_state = dataclasses.replace(
            st, token=token, hidden=torch.where(active[:, None], hidden, st.hidden),
            k_cache=kc, v_cache=vc, eos=st.eos | (token == eos_id), num_gen=num_gen,
        )
        return new_state, frame

    return body


def _segment_loop(body, state: DecodeState, segment: int, step_limit: torch.Tensor,
                  g: int) -> Tuple[DecodeState, torch.Tensor]:
    """Run up to ``segment`` frames, collecting them into a [B, segment, G]
    buffer (row b's valid frames are its num_gen). Ends early once every row
    is done (EOS or its ``step_limit``); that check reads one flag from the
    device per frame."""
    b = state.token.shape[0]
    buf = torch.zeros((b, segment, g), dtype=torch.int64, device=state.token.device)
    for tick in range(segment):
        if not bool((~state.eos & (state.num_gen < step_limit)).any()):
            break
        state, frame = body(state)
        buf[:, tick] = frame
    return state, buf


def decode_segment(
    talker_params: dict,
    st_params: dict,
    talker_cfg: TalkerConfig,
    state: DecodeState,
    trailing: torch.Tensor,
    *,
    sampling: SamplingConfig,
    st_sampling: SamplingConfig,
    segment: int,
    step_limit: Optional[Union[int, Sequence[int], torch.Tensor]] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """Resume ``state`` for up to ``segment`` frames: the streaming engine.
    Returns (state, codes [B, segment, G]); a row's new frames are its
    ``num_gen`` delta. ``step_limit`` (int or per row) caps each row's total
    frames (max_new_tokens), so a partial last segment needs nothing new; by
    default each row may take the whole segment. The KV cache (float or
    int8 dicts), the sampling generator and the repetition history carry
    over in ``state``."""
    b = state.token.shape[0]
    device = state.token.device
    limit = _row_limit(state.num_gen + segment if step_limit is None else step_limit, b, device)
    body = _frame_body(talker_params, st_params, talker_cfg, sampling, st_sampling,
                       trailing, limit, state.generator)
    return _segment_loop(body, state, segment, limit, talker_cfg.num_code_groups)


def generate_codes(
    talker_params: dict,
    st_params: dict,
    talker_cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D] left-padded prefix
    pad_mask: torch.Tensor,       # [B, S]
    trailing: torch.Tensor,       # [B, T+1, D] padded trailing text
    *,
    sampling: SamplingConfig,
    st_sampling: SamplingConfig,
    max_new_tokens: int,
    generator: Optional[torch.Generator],
    trim_last_on_budget: bool = True,
    step_limit: Optional[Union[int, Sequence[int]]] = None,
    kv_int8: bool = False,
) -> GenOutput:
    """Prefill + the full AR loop.

    ``trim_last_on_budget=False`` keeps all frames of budget-exhausted rows;
    by default they lose their final frame, as in the reference, which
    expands a step's code groups only at the next talker forward.

    ``step_limit`` (int or per-row, <= max_new_tokens) caps each row's
    frames below ``max_new_tokens``. ``kv_int8`` keeps the talker KV cache
    as int8 dicts."""
    b, s, _ = inputs_embeds.shape
    limit = _row_limit(max_new_tokens if step_limit is None else step_limit, b,
                       inputs_embeds.device)
    state, codes = init_decode(
        talker_params, talker_cfg, inputs_embeds, pad_mask, sampling=sampling,
        max_cache_len=s + max_new_tokens, generator=generator, kv_int8=kv_int8,
        st_params=st_params, st_sampling=st_sampling, first_segment=max_new_tokens,
        trailing=trailing, step_limit=limit)
    num_gen = state.num_gen
    if trim_last_on_budget:
        # max(0, …): a per-row step_limit of 0 yields an empty row.
        num_gen = torch.where(state.eos, num_gen,
                              torch.minimum(num_gen, limit - 1).clamp(min=0))
    return GenOutput(codes, num_gen, state.eos)
