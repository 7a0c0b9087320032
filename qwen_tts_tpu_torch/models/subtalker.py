"""Sub-talker ("code predictor"): expands each talker step into the remaining
codebook groups (PyTorch counterpart of ``qwen_tts_tpu/models/subtalker.py``).

A G-position sequential micro-decode per frame:

* position 0: the talker's post-norm last hidden state;
* position 1: the talker codec embedding of the frame's codebook-0 token; its
  output goes through ``lm_heads[0]`` → the group-1 token;
* position k >= 2: ``embeds[k-2]`` of the previous group's token; its output
  goes through ``lm_heads[k-1]`` → the group-k token.

Inputs pass through ``small_to_mtp_projection`` when the dims differ. The
group tables and heads are stacked ``[G-1, V, D]`` / ``[G-1, D, V]``. Each
micro-step runs the 5-layer trunk's decode step over a ``[L, B, G, KV, hd]``
cache, so the decode-attention kernel launches ``G × L`` times per frame.

The serving mode (``Qwen3TTSModel.quantize_for_serving``) stores the tables
and heads int8 with per-channel bf16 scales and replaces the trunk with its
int8 pack for ``subtalker_step`` (``params["trunk_packed"]``); each
micro-step then runs the whole trunk as one ``subtalker_step``: one kernel
launch per micro-step on the card, its plain version on the CPU. The routes
below run the int8 trunk layer by layer instead, untiled from the pack the
first time one runs (``SubtalkerPack.trunk``).

Environment gates, read when a frame is built (on the card: when it is
captured; ``st_env_token`` is part of every captured program's key, so a
flipped gate captures anew and flipping it back replays the old program):

* ``QTTS_ST_KV8=1``: the micro-decode's cache is an int8 dict (per token and
  head scales). The micro-step then runs layer by layer
  (``trunk_decode_step``) through the int8-cache decode-attention kernel:
  the ``subtalker_step`` kernel owns a cache in the activation dtype only.
* ``QTTS_ST_SPLIT=1``: the first G/2 positions attend over a half-length
  cache (the JAX package's two-phase schedule; the same bits). Off with
  ``QTTS_ST_KV8``.
* ``QTTS_ST_JACOBI=1`` (read by ``generate.py``'s frame):
  ``subtalker_generate_jacobi``, with ``QTTS_ST_JACOBI_ITERS`` forwards
  when set, else G-1 in a captured frame and the adaptive loop in an eager
  one.
* ``QTTS_ST_UNROLL`` / ``QTTS_ST_UNROLL_LAYERS`` steer XLA's unrolling in
  the JAX package and change nothing here; they stay in the token, as there.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from qwen_tts_tpu_torch.config import CodePredictorConfig
from qwen_tts_tpu_torch.models.trunk import (
    TrunkDims,
    init_trunk_params,
    quantize_int8,
    trunk_decode_step,
    trunk_prefill,
)
from qwen_tts_tpu_torch.ops.attention import KVCache
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig, exponential_race, sample_token
from qwen_tts_tpu_torch.ops.sampling_vec import VecSampling, sample_token_vec
from qwen_tts_tpu_torch.utils import normal_init

# The sub-talker's environment gates (module docstring), as the JAX package
# lists them.
ST_ENV_KEYS = (
    "QTTS_ST_JACOBI",
    "QTTS_ST_JACOBI_ITERS",
    "QTTS_ST_SPLIT",
    "QTTS_ST_KV8",
    "QTTS_ST_UNROLL",
    "QTTS_ST_UNROLL_LAYERS",
)


def st_env_token() -> tuple:
    """The gates' values now: part of a captured program's key."""
    return tuple(os.environ.get(k) for k in ST_ENV_KEYS)


def env_flag(name: str) -> bool:
    """A 0/1 gate, unset = 0."""
    return bool(int(os.environ.get(name, "0")))


def _layer_trunk(params: dict) -> dict:
    """The trunk that runs layer by layer: ``params["trunk"]``, or in the
    serving mode the int8 tree untiled from its pack."""
    return params["trunk"] if "trunk" in params else params["trunk_packed"].trunk()


def subtalker_dims(cfg: CodePredictorConfig) -> TrunkDims:
    return TrunkDims(
        num_layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        intermediate=cfg.intermediate_size,
        eps=cfg.rms_norm_eps,
        qk_norm=True,
    )


def init_subtalker_params(generator: torch.Generator, cfg: CodePredictorConfig,
                          talker_hidden: int, dtype=torch.float32, device=None) -> dict:
    """Random sub-talker weights (training and tests without a checkpoint):
    the G-1 group tables (talker width) and LM heads stacked, the trunk, the
    final norm, and ``small_to_mtp_projection`` where the widths differ; the
    JAX package's keys, shapes and dtypes."""
    g1 = cfg.num_code_groups - 1

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    device = device if device is not None else generator.device
    params = {
        "embeds": w((g1, cfg.vocab_size, talker_hidden), talker_hidden),
        "trunk": init_trunk_params(generator, subtalker_dims(cfg), dtype, device),
        "norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "lm_heads": w((g1, cfg.hidden_size, cfg.vocab_size), cfg.hidden_size),
    }
    if cfg.hidden_size != talker_hidden:
        params["input_proj"] = w((talker_hidden, cfg.hidden_size), talker_hidden)
        params["input_proj_b"] = torch.zeros((cfg.hidden_size,), dtype=dtype, device=device)
    return params


def _project_input(params: dict, x: torch.Tensor) -> torch.Tensor:
    """small_to_mtp_projection (identity when dims match)."""
    if "input_proj" in params:
        return x @ params["input_proj"] + params["input_proj_b"]
    return x


def quantize_subtalker_tables_int8(params: dict) -> dict:
    """int8 for the stacked embedding tables [G-1, V, D] and LM heads
    [G-1, D, V], with per-channel symmetric scales along the non-indexed
    axis, stored bf16 (``embeds_i8`` / ``embeds_s`` [G-1, 1, D], ``lm_heads_i8``
    / ``lm_heads_s`` [G-1, 1, V]). Idempotent."""
    out = dict(params)
    for k in ("embeds", "lm_heads"):
        if k in params:  # absent once quantized
            out[k + "_i8"], out[k + "_s"] = quantize_int8(out.pop(k))
    return out


def _embed_table(params: dict, table: int, code: torch.Tensor, dtype) -> torch.Tensor:
    """Row ``code`` of group table ``table`` (int8-aware)."""
    if "embeds_i8" in params:
        return params["embeds_i8"][table][code].to(dtype) * params["embeds_s"][table].to(dtype)
    return params["embeds"][table][code]


def _lm_head_logits(params: dict, hidden: torch.Tensor, head: int) -> torch.Tensor:
    """f32 logits of LM head ``head`` (int8-aware: the int8 GEMM)."""
    if "lm_heads_i8" in params:
        return int8_matmul(hidden, params["lm_heads_i8"][head], params["lm_heads_s"][head],
                           f32_out=True)
    return (hidden @ params["lm_heads"][head]).float()


def alloc_subtalker_cache(
    cfg: CodePredictorConfig, batch: int, dtype=torch.float32, device=None, *,
    kv_int8: bool = False, length: Optional[int] = None,
) -> Tuple[KVCache, KVCache]:
    """Per-frame micro-decode KV cache [L, B, G, KV, hd] (``length``
    positions instead of G if given). ``kv_int8``: int8 dicts ``{"i8",
    "s"}``, the scales [L, B, G, KV] f32 at 1e-8, as the JAX package
    allocates them."""
    shape = (cfg.num_hidden_layers, batch, length or cfg.num_code_groups,
             cfg.num_key_value_heads, cfg.head_dim)
    if kv_int8:
        return tuple({"i8": torch.zeros(shape, dtype=torch.int8, device=device),
                      "s": torch.full(shape[:-1], 1e-8, dtype=torch.float32, device=device)}
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def frame_noise(cfg: CodePredictorConfig, batch: int, sampling: Optional[SamplingConfig],
                vec_sampling: Optional[VecSampling], generator: Optional[torch.Generator],
                device) -> Optional[torch.Tensor]:
    """The frame's exponential races [G-1, B, V] for the draws of positions
    1..G-1 (position p takes slice p-1), drawn at once before position 1 so
    that the sequential and the Jacobi micro-decodes draw the same noise;
    None when no position samples (``sample_token_vec`` always draws)."""
    if vec_sampling is None and (sampling is None or not sampling.do_sample):
        return None
    return exponential_race((cfg.num_code_groups - 1, batch, cfg.vocab_size), generator, device)


def _draw(logits: torch.Tensor, sampling: Optional[SamplingConfig],
          vec_sampling: Optional[VecSampling], race: Optional[torch.Tensor]) -> torch.Tensor:
    """One position's codes [B] from its f32 logits [B, V] and its race."""
    if vec_sampling is not None:
        return sample_token_vec(logits, vec_sampling, None, race)
    return sample_token(logits, sampling, None, race)


def subtalker_generate(
    params: dict,
    cfg: CodePredictorConfig,
    talker_codec_embedding: torch.Tensor,  # [V_talker, D_talker] (group-0 table)
    prev_hidden: torch.Tensor,             # [B, D_talker] talker post-norm hidden
    first_code: torch.Tensor,              # [B] codebook-0 token
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    vec_sampling: Optional[VecSampling] = None,
    kv_int8: Optional[bool] = None,
) -> torch.Tensor:
    """Run the micro-decode for one frame. Returns codes [B, G] int64
    (column 0 = first_code). With ``vec_sampling`` each row draws its codes
    under its own controls (``sample_token_vec``; the sub-talker applies the
    warpers only, no penalty or EOS ban) and ``sampling`` is not read. The
    draws' noise comes from ``generator`` at once (``frame_noise``).

    ``kv_int8`` (None: ``QTTS_ST_KV8``) keeps the micro-decode's cache as
    int8 dicts. The route: with the serving mode's pack
    (``params["trunk_packed"]``) and a cache in the activation dtype, each
    position is one ``subtalker_step``; otherwise (no pack, or ``kv_int8``)
    each position runs ``trunk_decode_step`` over the trunk layer by layer
    (``_layer_trunk``), its attention through the decode-attention kernel of
    the cache's type. ``QTTS_ST_SPLIT=1`` (not with ``kv_int8``) runs positions
    < G/2 over a half-length cache on the layer-by-layer route; on the
    kernel route it changes nothing, since ``subtalker_step`` reads only the
    rows <= pos whatever the cache's length."""
    if kv_int8 is None:
        kv_int8 = env_flag("QTTS_ST_KV8")
    g = cfg.num_code_groups
    dims = subtalker_dims(cfg)
    b = prev_hidden.shape[0]
    dtype = params["norm"].dtype
    device = prev_hidden.device

    packed = None if kv_int8 else params.get("trunk_packed")
    split = env_flag("QTTS_ST_SPLIT") and g >= 8 and g % 2 == 0 and not kv_int8
    first_len = g // 2 if split and packed is None else g
    k_cache, v_cache = alloc_subtalker_cache(cfg, b, dtype, device, kv_int8=kv_int8,
                                             length=first_len)
    cos_all, sin_all = rope_cos_sin(
        torch.arange(g, device=device), cfg.head_dim, cfg.rope_theta)  # [G, hd]
    if packed is None:
        trunk = _layer_trunk(params)
        # Row-wise lengths for every position of the trunk step: pos + 1.
        lengths = torch.arange(1, g + 1, dtype=torch.int32, device=device)[:, None].repeat(1, b)
        valid_from = torch.zeros(b, dtype=torch.int32, device=device)
    noise = frame_noise(cfg, b, sampling, vec_sampling, generator, device)

    codes = [first_code]
    for pos in range(g):
        if pos == first_len:  # the split's second phase: the full-length cache
            k_full, v_full = alloc_subtalker_cache(cfg, b, dtype, device)
            k_full[:, :, :first_len], v_full[:, :, :first_len] = k_cache, v_cache
            k_cache, v_cache = k_full, v_full
        if pos == 0:
            x = prev_hidden.to(dtype)
        elif pos == 1:
            x = talker_codec_embedding[codes[-1]]
        else:
            x = _embed_table(params, pos - 2, codes[-1], dtype)
        x = _project_input(params, x)
        if packed is not None:
            hidden, k_cache, v_cache = subtalker_step(
                packed, x.contiguous(), cos_all[pos], sin_all[pos], k_cache, v_cache, pos,
                cfg.rms_norm_eps)
        else:
            hidden, k_cache, v_cache = trunk_decode_step(
                trunk, dims, x, cos_all[pos].expand(b, cfg.head_dim),
                sin_all[pos].expand(b, cfg.head_dim), k_cache, v_cache, lengths[pos],
                valid_from=valid_from,
            )
        if pos == 0:
            continue  # position 0 emits no token
        hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
        logits = _lm_head_logits(params, hidden, pos - 1)
        codes.append(_draw(logits, sampling, vec_sampling,
                           None if noise is None else noise[pos - 1]))
    return torch.stack(codes, dim=1)


def subtalker_generate_jacobi(
    params: dict,
    cfg: CodePredictorConfig,
    talker_codec_embedding: torch.Tensor,  # [V_talker, D_talker]
    prev_hidden: torch.Tensor,             # [B, D_talker]
    first_code: torch.Tensor,              # [B]
    *,
    sampling: Optional[SamplingConfig] = None,
    generator: Optional[torch.Generator] = None,
    vec_sampling: Optional[VecSampling] = None,
    fixed_iters: Optional[int] = None,
    return_iters: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, int]]:
    """The micro-decode as a Jacobi fixed-point iteration: codes [B, G]
    int64, those of ``subtalker_generate`` (exact).

    Guess every group at once and run full-sequence forwards, ``codes[p] =
    draw(lm_heads[p-1](trunk(inputs(codes))[p]))``: by causality group p is
    final after p forwards, so the fixed point is the sequential trace and
    G-1 forwards reach it. A forward is ``trunk_prefill`` over the G
    positions (1-D RoPE; the trunk float or int8, ``_layer_trunk``, its
    products at M = B x G), the final norm and the G-1 heads (int8-aware, in
    f32). Sampling draws position p with the same race as the sequential
    route (``frame_noise`` from ``generator``), so a sampled trace is the
    sequential one too. The sub-talker has no cache here, so ``QTTS_ST_KV8``
    and ``QTTS_ST_SPLIT`` change nothing.

    The loop: ``fixed_iters`` forwards when given (a captured frame, which
    cannot branch on device values, gives G-1: they reach the loop's codes,
    since a forward of the fixed point returns it); else the JAX package's
    loop, which reads the device after each forward and stops at the first
    that changes nothing, or after G-1. ``return_iters`` also returns the
    forwards run, the verifying one included, as the JAX package counts
    them."""
    g = cfg.num_code_groups
    dims = subtalker_dims(cfg)
    b = prev_hidden.shape[0]
    dtype = params["norm"].dtype
    device = prev_hidden.device
    trunk = _layer_trunk(params)
    noise = frame_noise(cfg, b, sampling, vec_sampling, generator, device)
    cos, sin = rope_cos_sin(torch.arange(g, device=device).expand(b, g), cfg.head_dim,
                            cfg.rope_theta)  # [B, G, hd]
    head = torch.cat([prev_hidden.to(dtype)[:, None],
                      talker_codec_embedding[first_code].to(dtype)[:, None]], dim=1)
    tables = torch.arange(g - 2, device=device)[:, None]

    def forward(codes: torch.Tensor) -> torch.Tensor:
        # Position p >= 2 takes group p-1's code through table p-2.
        prev = codes[:, 1: g - 1].T  # [G-2, B]
        if "embeds_i8" in params:
            rest = (params["embeds_i8"][tables, prev].to(dtype)
                    * params["embeds_s"][tables[:, 0]].to(dtype))
        else:
            rest = params["embeds"][tables, prev]
        x = _project_input(params, torch.cat([head, rest.transpose(0, 1).to(dtype)], dim=1))
        hidden, _, _ = trunk_prefill(trunk, dims, x, cos, sin)
        hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
        logits = [_lm_head_logits(params, hidden[:, p], p - 1) for p in range(1, g)]
        if noise is None:  # greedy: one argmax over [B, G-1, V]
            new = torch.stack(logits, dim=1).argmax(dim=-1)
        else:
            new = torch.stack([_draw(lg, sampling, vec_sampling, noise[p])
                               for p, lg in enumerate(logits)], dim=1)
        return torch.cat([first_code[:, None], new], dim=1)

    codes = torch.cat([first_code[:, None], first_code.new_zeros(b, g - 1)], dim=1)
    if fixed_iters is not None:
        for _ in range(fixed_iters):
            codes = forward(codes)
        iters = fixed_iters
    else:
        iters = 0
        while iters < g - 1:
            new = forward(codes)
            iters += 1
            if torch.equal(new, codes):
                break
            codes = new
    return (codes, iters) if return_iters else codes


def embed_groups_sum(
    params: dict,
    talker_codec_embedding: torch.Tensor,  # [V_talker, D_talker]
    codes: torch.Tensor,                   # [B, G]
) -> torch.Tensor:
    """Σ of all G group embeddings — the talker's next-frame audio-track
    input. Group 0 uses the talker table; groups 1..G-1 the stacked
    sub-talker tables (one batched gather)."""
    g = codes.shape[1]
    first = talker_codec_embedding[codes[:, 0]]                      # [B, D]
    group_ids = torch.arange(g - 1, device=codes.device)
    if "embeds_i8" in params:
        rest = params["embeds_i8"][group_ids[:, None], codes[:, 1:].T]
        rest = rest.to(first.dtype) * params["embeds_s"].to(first.dtype)
    else:
        rest = params["embeds"][group_ids[:, None], codes[:, 1:].T]  # [G-1, B, D]
    return first + rest.sum(dim=0)
