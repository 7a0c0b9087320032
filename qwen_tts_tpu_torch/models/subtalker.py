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
int8 pack for ``subtalker_step`` (``params["trunk_packed"]``); each micro-step then
runs the whole trunk as one ``subtalker_step``: one kernel launch per
micro-step on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qwen_tts_tpu_torch.config import CodePredictorConfig
from qwen_tts_tpu_torch.models.trunk import TrunkDims, quantize_int8, trunk_decode_step
from qwen_tts_tpu_torch.ops.cuda.int8_matmul import int8_matmul
from qwen_tts_tpu_torch.ops.cuda.subtalker_step import subtalker_step
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig, sample_token
from qwen_tts_tpu_torch.ops.sampling_vec import VecSampling, sample_token_vec


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
    cfg: CodePredictorConfig, batch: int, dtype=torch.float32, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame micro-decode KV cache [L, B, G, KV, hd]."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_code_groups,
             cfg.num_key_value_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def subtalker_generate(
    params: dict,
    cfg: CodePredictorConfig,
    talker_codec_embedding: torch.Tensor,  # [V_talker, D_talker] (group-0 table)
    prev_hidden: torch.Tensor,             # [B, D_talker] talker post-norm hidden
    first_code: torch.Tensor,              # [B] codebook-0 token
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    vec_sampling: Optional[VecSampling] = None,
) -> torch.Tensor:
    """Run the micro-decode for one frame. Returns codes [B, G] int64
    (column 0 = first_code). With ``vec_sampling`` each row draws its codes
    under its own controls (``sample_token_vec``; the sub-talker applies the
    warpers only, no penalty or EOS ban) and ``sampling`` is not read."""
    g = cfg.num_code_groups
    dims = subtalker_dims(cfg)
    b = prev_hidden.shape[0]
    dtype = params["norm"].dtype
    device = prev_hidden.device

    packed = params.get("trunk_packed")
    k_cache, v_cache = alloc_subtalker_cache(cfg, b, dtype, device)
    cos_all, sin_all = rope_cos_sin(
        torch.arange(g, device=device), cfg.head_dim, cfg.rope_theta)  # [G, hd]
    if packed is None:
        # Row-wise lengths for every position of the trunk step: pos + 1.
        lengths = torch.arange(1, g + 1, dtype=torch.int32, device=device)[:, None].repeat(1, b)
        valid_from = torch.zeros(b, dtype=torch.int32, device=device)

    codes = [first_code]
    for pos in range(g):
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
                params["trunk"], dims, x, cos_all[pos].expand(b, cfg.head_dim),
                sin_all[pos].expand(b, cfg.head_dim), k_cache, v_cache, lengths[pos],
                valid_from=valid_from,
            )
        if pos == 0:
            continue  # position 0 emits no token
        hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
        logits = _lm_head_logits(params, hidden, pos - 1)
        codes.append(sample_token(logits, sampling, generator) if vec_sampling is None
                     else sample_token_vec(logits, vec_sampling, generator))
    return torch.stack(codes, dim=1)


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
