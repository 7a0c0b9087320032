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

On the card a frame is one CUDA graph, captured once per configuration and
replayed frame after frame on buffers that hold the decode state
(``_FrameGraph``, ``graphs.py``): the counterpart of the JAX package's one
jitted ``while_loop``. The host reads whether any row is still active only
every ``CHECK_EVERY`` frames; the frames run past the point where every row
is done change nothing. On the CPU the same frames and checks run eagerly.
The prefill stays eager.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qwen_tts_tpu_torch import graphs
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
from qwen_tts_tpu_torch.ops.sampling_vec import (
    VecSampling,
    apply_repetition_penalty_vec,
    sample_token_vec,
)

# The host reads whether any row is still active once every CHECK_EVERY
# frames. Each read waits until the card has run every frame queued before
# it: reading every frame would make the host wait on each one, and its own
# delays would reach the card; with eight frames queued ahead they do not.
# Once every row is done, the frames up to the next read still run (at most
# CHECK_EVERY - 1) and change nothing: at most 7 frames at the end of a
# request that runs up to 2048. A stream's 25-frame segment reads 3 times.
CHECK_EVERY = 8
# A captured frame's trailing text has a multiple of this many rows (padded
# with tts_pad, which a row takes past its text anyway), so texts of similar
# length share one graph.
TRAILING_BUCKET = 32


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
    speaker_embed: Optional[np.ndarray] = None,  # x-vector slot (Base models)
    instruct_ids: Optional[Sequence[int]] = None,
    non_streaming: bool = False,
    ref_ids: Optional[Sequence[int]] = None,      # ICL voice clone
    ref_codes: Optional[np.ndarray] = None,       # [T_ref, G]
    st_params: Optional[dict] = None,             # for the ref codes' embeddings
) -> Prompt:
    """Build the dual-track prefix for one utterance.

    ``text_ids`` is the full chat-templated id sequence
    ``[im_start, assistant, \\n, TEXT..., im_end, \\n, im_start, assistant, \\n]``:
    positions [0:3] are the role header, [3:-5] the content.

    A voice clone passes its x-vector as ``speaker_embed`` (float32; it takes
    the speaker slot, and the pieces it meets are summed in float32, as the
    JAX package's numpy prompt does), and in ICL mode the reference text's ids
    ``ref_ids`` (``build_ref_text`` tokenized) with its codes ``ref_codes``
    (``icl_ref_codes`` of the voice file's codes), whose embeddings come
    from the talker's and ``st_params``' tables."""
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
    if speaker_embed is not None:
        spk_vec = torch.as_tensor(np.asarray(speaker_embed, np.float32), device=device)
    elif speaker:
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

    if ref_codes is not None:
        if st_params is None:
            raise ValueError("ICL prompts need st_params for ref-code embeddings")
        icl, trailing = _build_icl(params, st_params, cfg, text_ids,
                                   np.asarray(ref_ids, np.int64), ref_codes, tts_pad,
                                   tts_eos, non_streaming)
        pieces.append(icl)
        return Prompt(torch.cat(pieces, dim=0), trailing, tts_pad)

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


def icl_ref_codes(ref_codes: np.ndarray, num_code_groups: int) -> np.ndarray:
    """A clone's reference codes [T_ref, >= G] as the talker takes them: the
    first ``num_code_groups`` columns (the columns the decode's merge keeps;
    a torch gather would refuse the JAX package's clamped extra groups).
    Narrower codes come from a model with fewer groups and raise."""
    rc = np.asarray(ref_codes, np.int64)
    if rc.ndim != 2 or rc.shape[1] < num_code_groups:
        raise ValueError(
            f"ref_codes have {rc.shape[-1] if rc.ndim else 0} groups, talker emits "
            f"{num_code_groups} — ICL clone needs equal widths")
    return rc[:, :num_code_groups]


def _build_icl(
    params: dict,
    st_params: dict,
    cfg: TTSConfig,
    text_ids: np.ndarray,
    ref_ids: np.ndarray,
    ref_codes: np.ndarray,
    tts_pad: torch.Tensor,
    tts_eos: torch.Tensor,
    non_streaming: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICL voice-clone prefix: the reference text then the target text on the
    text track, over codec_bos and the reference codes' Σ-embeddings on the
    codec track. Returns (icl_embeds, trailing_text): streaming sums the
    tracks position by position (the longer text trails into the decode),
    ``non_streaming`` lays the text (over codec_pad) before the codes (over
    tts_pad)."""
    tk = cfg.talker
    device = params["codec_embedding"].device
    ids = torch.as_tensor(np.concatenate([ref_ids[3:-2], text_ids[3:-5]]), device=device)
    text_embed = torch.cat([talker_mod.embed_text(params, ids), tts_eos[None]], dim=0)
    codes = torch.as_tensor(np.asarray(ref_codes, np.int64), device=device)
    if codes.ndim != 2 or codes.shape[1] != tk.num_code_groups:
        raise ValueError(f"ref_codes of shape {tuple(codes.shape)}, talker emits "
                         f"{tk.num_code_groups} groups: cut them with icl_ref_codes")
    sums = st_mod.embed_groups_sum(st_params, params["codec_embedding"], codes)
    special = talker_mod.embed_codec(
        params, torch.as_tensor([tk.codec_bos_id, tk.codec_pad_id], device=device))
    codec_embed = torch.cat([special[:1], sums], dim=0)

    text_lens, codec_lens = text_embed.shape[0], codec_embed.shape[0]
    if non_streaming:
        icl = torch.cat([text_embed + special[1][None], codec_embed + tts_pad[None]], dim=0)
        return icl, tts_pad[None]
    if text_lens > codec_lens:
        return text_embed[:codec_lens] + codec_embed, text_embed[codec_lens:]
    padded = torch.cat([text_embed, tts_pad[None].expand(codec_lens - text_lens, -1)], dim=0)
    return padded + codec_embed, tts_pad[None]


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


def _processor(talker_cfg: TalkerConfig, sampling: SamplingConfig, device,
               vec_sampling: Optional[VecSampling] = None):
    """Logits pipeline: suppress → min-new-tokens EOS ban → repetition
    penalty → sample. With ``vec_sampling`` every control is per row (a slot
    pool serves requests of different controls in one program) and
    ``sampling`` is not read."""
    vocab = talker_cfg.vocab_size
    eos_id = talker_cfg.codec_eos_token_id
    suppress = build_suppress_mask(vocab, eos_id, tail=talker_cfg.suppress_tail,
                                   device=device)
    is_eos = torch.arange(vocab, device=device) == eos_id

    def process_and_sample(logits, presence, num_sampled, generator):
        logits = apply_suppress_mask(logits, suppress[None])
        if vec_sampling is not None:
            ban = num_sampled < vec_sampling.min_new_tokens  # [B]
            logits = logits.masked_fill(ban[:, None] & is_eos[None], NEG_INF)
            logits = apply_repetition_penalty_vec(logits, presence,
                                                  vec_sampling.repetition_penalty)
            return sample_token_vec(logits, vec_sampling, generator)
        if sampling.min_new_tokens > 0:
            ban = num_sampled < sampling.min_new_tokens  # [B]
            logits = logits.masked_fill(ban[:, None] & is_eos[None], NEG_INF)
        logits = apply_repetition_penalty(logits, presence, sampling.repetition_penalty)
        return sample_token(logits, sampling, generator)

    return process_and_sample


def _prefill(
    talker_params: dict,
    talker_cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D] left-padded prefix
    pad_mask: torch.Tensor,       # [B, S]
    *,
    sampling: SamplingConfig,
    max_cache_len: int,
    generator: Optional[torch.Generator],
    kv_int8: bool = False,
    vec_sampling: Optional[VecSampling] = None,
) -> DecodeState:
    """Prefill + first-token sample: the decode state before the first frame.
    With ``vec_sampling`` token 0 honours each row's own controls."""
    b, s, _ = inputs_embeds.shape
    device = inputs_embeds.device
    k_cache, v_cache = talker_mod.alloc_kv_cache(
        talker_cfg, b, max_cache_len, talker_params["norm"].dtype, device, kv_int8=kv_int8)
    pre = talker_mod.talker_prefill(
        talker_params, talker_cfg, inputs_embeds, pad_mask, k_cache, v_cache)
    n_real = pad_mask.int().sum(dim=-1, dtype=torch.int32)
    presence = torch.zeros((b, talker_cfg.vocab_size), dtype=torch.bool, device=device)
    zeros = torch.zeros(b, dtype=torch.int32, device=device)
    token0 = _processor(talker_cfg, sampling, device, vec_sampling)(
        pre.logits, presence, zeros, generator)
    presence.index_put_((torch.arange(b, device=device), token0), _true(device))
    return DecodeState(
        token=token0, hidden=pre.last_hidden, k_cache=pre.k_cache, v_cache=pre.v_cache,
        presence=presence, eos=token0 == talker_cfg.codec_eos_token_id, num_gen=zeros,
        prefix_len=torch.full((b,), s, dtype=torch.int32, device=device),
        n_real=n_real, valid_from=s - n_real, generator=generator,
    )


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
    vec_sampling: Optional[VecSampling] = None,
    st_vec_sampling: Optional[VecSampling] = None,
) -> Union[DecodeState, Tuple[DecodeState, torch.Tensor]]:
    """Prefill + first-token sample; returns the decode state. ``kv_int8``
    keeps the talker KV cache as int8 dicts.

    With ``first_segment > 0`` (needs ``st_params``, ``st_sampling`` and
    ``trailing``) the first frames run right after the prefill, and the
    result is ``(state, codes [B, first_segment, G])``, as from
    ``decode_segment``. ``step_limit`` (int or per row) caps each row's
    frames; it defaults to ``first_segment``.

    ``vec_sampling`` / ``st_vec_sampling`` make the talker's and the
    sub-talker's controls per row from token 0 on (the continuous engine
    admits requests through here, and token 0 must honour the request's own
    controls, not the engine's)."""
    state = _prefill(talker_params, talker_cfg, inputs_embeds, pad_mask, sampling=sampling,
                     max_cache_len=max_cache_len, generator=generator, kv_int8=kv_int8,
                     vec_sampling=vec_sampling)
    if first_segment <= 0:
        return state
    limit = _row_limit(first_segment if step_limit is None else step_limit,
                       inputs_embeds.shape[0], inputs_embeds.device)
    return _decode(talker_params, st_params, talker_cfg, sampling, st_sampling, state,
                   trailing, limit, first_segment, vec_sampling, st_vec_sampling)


def _true(device) -> torch.Tensor:
    """A bool True on ``device``: an indexed write of the Python value
    would copy it from the host, which a CUDA graph capture refuses."""
    return torch.ones((), dtype=torch.bool, device=device)


def _row_limit(step_limit: Union[int, Sequence[int], torch.Tensor], b: int,
               device) -> torch.Tensor:
    """A frame budget (int or per row) as an int32 [B] tensor."""
    return torch.as_tensor(step_limit, dtype=torch.int32, device=device).expand(b)


def _any_active(state: DecodeState, step_limit: torch.Tensor) -> torch.Tensor:
    """Whether any row may still take a frame (device bool)."""
    return (~state.eos & (state.num_gen < step_limit)).any()


def _frame_body(
    talker_params: dict,
    st_params: dict,
    talker_cfg: TalkerConfig,
    sampling: SamplingConfig,
    st_sampling: SamplingConfig,
    trailing: torch.Tensor,
    step_limit: torch.Tensor,  # [B] per-row frame budget
    generator: Optional[torch.Generator],
    vec_sampling: Optional[VecSampling] = None,
    st_vec_sampling: Optional[VecSampling] = None,
):
    """One frame of the AR loop: sub-talker → Σ-embed + trailing → talker
    step → sample. Positions are per row (from ``num_gen``); with
    ``vec_sampling`` / ``st_vec_sampling`` so are the talker's and the
    sub-talker's sampling controls, read from those tensors at each frame.

    A frame in which no row is active changes nothing of the state and
    returns zeros, as a loop that stopped before it would have left them.
    The host reads no device value: the frame is captured as a CUDA graph."""
    eos_id = talker_cfg.codec_eos_token_id
    trailing_max = trailing.shape[1] - 1
    process_and_sample = _processor(talker_cfg, sampling, trailing.device, vec_sampling)
    dtype = talker_params["norm"].dtype
    rows = torch.arange(trailing.shape[0], device=trailing.device)
    true = _true(trailing.device)

    def body(st: DecodeState) -> Tuple[DecodeState, torch.Tensor]:
        active = ~st.eos & (st.num_gen < step_limit)

        # 1) the sub-talker expands the current token into all groups.
        frame = st_mod.subtalker_generate(
            st_params, talker_cfg.code_predictor, talker_params["codec_embedding"],
            st.hidden, st.token, st_sampling, generator, st_vec_sampling,
        )  # [B, G]
        num_gen = st.num_gen + active.int()

        # 2) next talker input: Σ group embeddings + trailing text / tts_pad.
        emb = st_mod.embed_groups_sum(st_params, talker_params["codec_embedding"], frame)
        emb = emb + trailing[rows, st.num_gen.clamp(max=trailing_max).long()]

        # 3) talker step at each row's own cache and rope position. Inactive
        #    rows rewrite their next slot (masked out, harmless: a later real
        #    frame writes it before it reads it); a row whose cache is full,
        #    which takes no further frame, rewrites its last slot instead.
        s_max = _cache_slots(st.k_cache)
        logits, hidden, kc, vc = talker_mod.talker_decode_step(
            talker_params, talker_cfg, emb.to(dtype), st.n_real + st.num_gen,
            st.k_cache, st.v_cache, (st.prefix_len + st.num_gen + 1).clamp(max=s_max),
            st.valid_from,
        )

        # 4) sample the next codebook-0 token.
        token = process_and_sample(logits, st.presence, st.num_gen + 1, generator)
        token = torch.where(active, token, st.token)
        st.presence.index_put_((rows, token), true)
        new_state = dataclasses.replace(
            st, token=token, hidden=torch.where(active[:, None], hidden, st.hidden),
            k_cache=kc, v_cache=vc, eos=st.eos | (token == eos_id), num_gen=num_gen,
        )
        return new_state, frame.masked_fill(~active.any(), 0)

    return body


def _cache_slots(cache: KVCache) -> int:
    """S_max of a talker cache [L, B, S_max, KV, hd] (tensor or int8 dict)."""
    return (cache["i8"] if isinstance(cache, dict) else cache).shape[2]


def _frame_loop(body, state: DecodeState, segment: int, step_limit: torch.Tensor, g: int,
                check: bool = True) -> Tuple[DecodeState, torch.Tensor]:
    """Run up to ``segment`` frames, collecting them into a [B, segment, G]
    buffer (row b's valid frames are its num_gen delta). With ``check``, the
    loop ends once every row is done (EOS or its ``step_limit``), read from
    the device every ``CHECK_EVERY`` frames; the frames between the point
    where all rows are done and the read change nothing and leave zeros in
    the buffer, so the result is that of a loop that stopped at once."""
    b = state.token.shape[0]
    buf = torch.zeros((b, segment, g), dtype=torch.int64, device=state.token.device)
    for tick in range(segment):
        if (check and tick and tick % CHECK_EVERY == 0
                and not bool(_any_active(state, step_limit))):
            break
        state, frame = body(state)
        buf[:, tick] = frame
    return state, buf


def _decode_eager(talker_params: dict, st_params: dict, talker_cfg: TalkerConfig,
                  sampling: SamplingConfig, st_sampling: SamplingConfig, state: DecodeState,
                  trailing: torch.Tensor, step_limit: torch.Tensor, segment: int,
                  vec_sampling: Optional[VecSampling] = None,
                  st_vec_sampling: Optional[VecSampling] = None,
                  check: bool = True) -> Tuple[DecodeState, torch.Tensor]:
    """``_frame_loop`` over ``_frame_body``, each op run as it comes."""
    body = _frame_body(talker_params, st_params, talker_cfg, sampling, st_sampling,
                       trailing, step_limit, state.generator, vec_sampling, st_vec_sampling)
    return _frame_loop(body, state, segment, step_limit, talker_cfg.num_code_groups, check)


def _decode(talker_params: dict, st_params: dict, talker_cfg: TalkerConfig,
            sampling: SamplingConfig, st_sampling: SamplingConfig, state: DecodeState,
            trailing: torch.Tensor, step_limit: torch.Tensor, segment: int,
            vec_sampling: Optional[VecSampling] = None,
            st_vec_sampling: Optional[VecSampling] = None,
            ) -> Tuple[DecodeState, torch.Tensor]:
    """Up to ``segment`` frames from ``state``, as ``_frame_loop`` runs
    them: on the card, replays of one captured frame (``_FrameGraph``); on
    the CPU, the same frames run eagerly. The program's key marks per-row
    sampling, not its values: one capture serves every mix of controls."""
    if not state.token.is_cuda:
        return _decode_eager(talker_params, st_params, talker_cfg, sampling, st_sampling,
                             state, trailing, step_limit, segment, vec_sampling, st_vec_sampling)
    rows = trailing_rows(trailing)
    cache = state.k_cache
    key = ("frame", state.token.device, tuple(state.hidden.shape), state.hidden.dtype,
           _cache_slots(cache), "int8" if isinstance(cache, dict) else cache.dtype,
           rows, trailing.dtype, sampling, st_sampling, talker_cfg,
           "vec" if vec_sampling is not None else None,
           "st_vec" if st_vec_sampling is not None else None)
    program = graphs.cached(key, (talker_params, st_params), lambda: _FrameGraph(
        talker_params, st_params, talker_cfg, sampling, st_sampling, state, trailing,
        step_limit, rows, vec_sampling, st_vec_sampling))
    return program.run(state, trailing, step_limit, segment, vec_sampling, st_vec_sampling)


# --------------------------------------------------------------------------
# The decode on the card: one frame captured as a CUDA graph
# --------------------------------------------------------------------------

# The tensors of a decode state, in the order DecodeState lists them.
STATE_FIELDS = ("token", "hidden", "k_cache", "v_cache", "presence", "eos", "num_gen",
                "prefix_len", "n_real", "valid_from")


def buffer_like(x: KVCache) -> KVCache:
    """A contiguous uninitialised tensor (or int8 dict) like ``x``."""
    if isinstance(x, dict):
        return {k: buffer_like(v) for k, v in x.items()}
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def copy_into(dst: KVCache, src: KVCache) -> None:
    """``src`` (a tensor or int8 dict) into ``dst`` in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def clone_state(state: DecodeState) -> DecodeState:
    """``state`` with every tensor copied."""
    def clone(x):
        return {k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()

    return dataclasses.replace(state, **{f: clone(getattr(state, f)) for f in STATE_FIELDS})


def trailing_rows(trailing: torch.Tensor) -> int:
    """The rows a captured program holds for ``trailing`` [B, T+1, D]."""
    return -(-trailing.shape[1] // TRAILING_BUCKET) * TRAILING_BUCKET


def fill_trailing(dst: torch.Tensor, trailing: torch.Tensor) -> None:
    """``trailing`` [B, T+1, D] into ``dst`` [B, R >= T+1, D], the rows past
    T+1 repeating the last, which is tts_pad for every row (``batch_prompts``):
    the frame takes that row past a row's text either way."""
    n = trailing.shape[1]
    dst[:, :n].copy_(trailing)
    dst[:, n:].copy_(trailing[:, -1:].expand(-1, dst.shape[1] - n, -1))


class _FrameGraph:
    """One frame of the decode loop captured on the card, with the decode
    state it advances in place (one configuration: batch, cache, trailing
    bucket, dtypes, sampling configs or per-row sampling, parameter trees).

    ``run`` copies the caller's state into the buffers, unless it is the
    state the last ``run`` returned, whose tensors are these buffers (the
    stream's next segment, or a slot pool whose rows were written in
    place). A state passed in is consumed, as the JAX package donates it; if
    the buffers still hold the state returned to another caller, that state
    first gets tensors of its own. The trailing text, the frame budgets and
    the per-row sampling controls are loaded into their buffers at every
    ``run``."""

    def __init__(self, talker_params, st_params, talker_cfg, sampling, st_sampling,
                 state: DecodeState, trailing: torch.Tensor, step_limit: torch.Tensor,
                 rows: int, vec_sampling: Optional[VecSampling] = None,
                 st_vec_sampling: Optional[VecSampling] = None):
        b, d = state.hidden.shape
        device = state.token.device
        self.state = DecodeState(**{f: buffer_like(getattr(state, f)) for f in STATE_FIELDS})
        self.trailing = torch.empty((b, rows, d), dtype=trailing.dtype, device=device)
        self.limit = torch.empty(b, dtype=torch.int32, device=device)
        self.vec = None if vec_sampling is None else vec_sampling.buffer_like()
        self.st_vec = None if st_vec_sampling is None else st_vec_sampling.buffer_like()
        self.frame = torch.zeros((b, talker_cfg.num_code_groups), dtype=torch.int64,
                                 device=device)
        self.more = torch.zeros((), dtype=torch.bool, device=device)
        self.host_more = torch.zeros((), dtype=torch.bool, pin_memory=True)
        self.lent = None
        draws = (sampling.do_sample or st_sampling.do_sample or self.vec is not None
                 or self.st_vec is not None)
        generator = torch.Generator(device=device) if draws else None
        body = _frame_body(talker_params, st_params, talker_cfg, sampling, st_sampling,
                           self.trailing, self.limit, generator, self.vec, self.st_vec)
        st = self.state

        def frame():
            new, codes = body(st)
            for f in ("token", "hidden", "eos", "num_gen"):
                getattr(st, f).copy_(getattr(new, f))
            self.frame.copy_(codes)
            self.more.copy_(_any_active(new, self.limit))

        # The warm-up frame runs on it.
        self._load(state, trailing, step_limit, vec_sampling, st_vec_sampling)
        self.graph = graphs.Graph(frame, generator)

    def _load(self, state: DecodeState, trailing: torch.Tensor, step_limit: torch.Tensor,
              vec_sampling: Optional[VecSampling], st_vec_sampling: Optional[VecSampling],
              ) -> None:
        st = self.state
        if state.token is not st.token:
            holder = self.lent() if self.lent is not None else None
            if holder is not None and holder.token is st.token:
                own = clone_state(holder)
                for f in STATE_FIELDS:
                    setattr(holder, f, getattr(own, f))
            for f in STATE_FIELDS:
                copy_into(getattr(st, f), getattr(state, f))
        fill_trailing(self.trailing, trailing)
        self.limit.copy_(step_limit)
        for buf, src in ((self.vec, vec_sampling), (self.st_vec, st_vec_sampling)):
            if buf is not None:
                buf.copy_(src)

    def run(self, state: DecodeState, trailing: torch.Tensor, step_limit: torch.Tensor,
            segment: int, vec_sampling: Optional[VecSampling] = None,
            st_vec_sampling: Optional[VecSampling] = None) -> Tuple[DecodeState, torch.Tensor]:
        """``_frame_loop`` by replays: the flag of whether any row is still
        active is read every CHECK_EVERY frames, after the frames before it
        are queued. Holds ``graphs.device_lock``: the buffers are shared by
        every caller of this program."""
        with graphs.device_lock:
            self._load(state, trailing, step_limit, vec_sampling, st_vec_sampling)
            buf = torch.zeros((self.frame.shape[0], segment, self.frame.shape[1]),
                              dtype=torch.int64, device=self.frame.device)
            with self.graph.drawing_from(state.generator):
                for tick in range(segment):
                    if (tick and tick % CHECK_EVERY == 0
                            and not graphs.read_flag(self.more, self.host_more)):
                        break
                    self.graph.replay()
                    buf[:, tick] = self.frame
            out = dataclasses.replace(self.state, generator=state.generator)
            self.lent = weakref.ref(out)
            return out, buf


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
    vec_sampling: Optional[VecSampling] = None,
    st_vec_sampling: Optional[VecSampling] = None,
    with_report: bool = False,
) -> Union[Tuple[DecodeState, torch.Tensor],
           Tuple[DecodeState, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Resume ``state`` for up to ``segment`` frames: the streaming engine.
    Returns (state, codes [B, segment, G]); a row's new frames are its
    ``num_gen`` delta. ``step_limit`` (int or per row) caps each row's total
    frames (max_new_tokens), so a partial last segment needs nothing new; by
    default each row may take the whole segment. The KV cache (float or
    int8 dicts), the sampling generator and the repetition history carry
    over in ``state``, which is consumed: on the card the returned state's
    tensors are the captured frame's buffers, which the next call with
    another state rewrites once this one holds copies of its own.
    ``vec_sampling`` / ``st_vec_sampling`` make every sampling control per
    row (``sampling`` and ``st_sampling`` then only name the program).

    ``with_report=True`` adds a third output, ``(num_gen, eos)`` in tensors
    of their own: copies taken on the stream right after the segment. The
    returned state's tensors are the frame program's buffers, which the next
    segment's replays overwrite; a double-buffered caller dispatches that
    segment before it reads this one's report."""
    b = state.token.shape[0]
    device = state.token.device
    limit = _row_limit(state.num_gen + segment if step_limit is None else step_limit, b, device)
    state, codes = _decode(talker_params, st_params, talker_cfg, sampling, st_sampling, state,
                           trailing, limit, segment, vec_sampling, st_vec_sampling)
    if not with_report:
        return state, codes
    return state, codes, (state.num_gen.clone(), state.eos.clone())


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
    num_gen = state.num_gen.clone()
    if trim_last_on_budget:
        # max(0, …): a per-row step_limit of 0 yields an empty row.
        num_gen = torch.where(state.eos, num_gen,
                              torch.minimum(num_gen, limit - 1).clamp(min=0))
    return GenOutput(codes, num_gen, state.eos.clone())
