"""Greedy-parity validation: the production decode loop against an
independent, cache-free eager decoder (the PyTorch counterpart of
``qwen_tts_tpu/validation.py``).

The oracle is an architecturally different decode path: every step re-runs
``talker_prefill`` over the whole prefix **without any KV cache carried
over**, and the sub-talker runs as an explicit per-position loop through
``trunk_decode_step``. The fast path is the production ``generate_codes``:
on the card, replays of the captured frame with the decode-attention kernel
(the oracle's sub-talker loop reaches the same kernel through
``trunk_decode_step``; its talker never does). Agreement of the greedy
codebook-0 traces, stop reason and stop step included, proves the
fixed-shape cached attention, masking and position bookkeeping of the fast
path. Both run where the parameters are.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch

from qwen_tts_tpu_torch.config import TTSConfig
from qwen_tts_tpu_torch.generate import GenerationParams, Prompt, batch_prompts, generate_codes
from qwen_tts_tpu_torch.models import subtalker as st_mod
from qwen_tts_tpu_torch.models import talker as talker_mod
from qwen_tts_tpu_torch.models.trunk import trunk_decode_step
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin
from qwen_tts_tpu_torch.ops.sampling import build_suppress_mask


class Trace(NamedTuple):
    tokens: List[int]        # codebook-0 trace (excluding EOS)
    stop_reason: str         # "eos" | "max_tokens"
    stop_step: int


def _greedy_eager_subtalker(st_params, cp_cfg, talker_emb, hidden, first_code):
    """Per-position loop — mirrors the schedule explicitly."""
    dims = st_mod.subtalker_dims(cp_cfg)
    device = hidden.device
    kc, vc = st_mod.alloc_subtalker_cache(cp_cfg, 1, st_params["norm"].dtype, device)
    codes = [int(first_code)]
    prev = torch.tensor([first_code], dtype=torch.int64, device=device)
    for pos in range(cp_cfg.num_code_groups):
        if pos == 0:
            x = hidden[None]
        elif pos == 1:
            x = talker_emb[prev]
        else:
            x = st_params["embeds"][pos - 2][prev]
        x = st_mod._project_input(st_params, x)
        cos, sin = rope_cos_sin(torch.full((1,), pos, device=device), cp_cfg.head_dim,
                                cp_cfg.rope_theta)
        h, kc, vc = trunk_decode_step(st_params["trunk"], dims, x, cos, sin, kc, vc,
                                      torch.full((1,), pos + 1, dtype=torch.int32,
                                                 device=device))
        h = rms_norm(h, st_params["norm"], cp_cfg.rms_norm_eps)
        if pos >= 1:
            logits = h @ st_params["lm_heads"][pos - 1]
            prev = torch.argmax(logits, -1)
            codes.append(int(prev[0]))
    return codes


def eager_greedy_trace(
    talker_params: dict,
    st_params: dict,
    cfg: TTSConfig,
    prompt: Prompt,
    max_new_tokens: int,
) -> Trace:
    """Cache-free greedy decode: the whole prefix is re-forwarded each step.
    The prefix is kept in f32, as the JAX oracle keeps it, and enters the
    talker in its parameters' dtype."""
    tk = cfg.talker
    dtype = talker_params["norm"].dtype
    device = prompt.embeds.device
    suppress = build_suppress_mask(tk.vocab_size, tk.codec_eos_token_id, tail=tk.suppress_tail,
                                   device=device)
    embeds = prompt.embeds.float()
    trailing = prompt.trailing_text.float()
    tts_pad = prompt.tts_pad_embed.float()

    tokens: List[int] = []
    for step in range(max_new_tokens + 1):
        s = embeds.shape[0]
        kc, vc = talker_mod.alloc_kv_cache(tk, 1, s, torch.float32, device)
        out = talker_mod.talker_prefill(
            talker_params, tk, embeds[None].to(dtype),
            torch.ones((1, s), dtype=torch.bool, device=device), kc, vc,
        )
        logits = out.logits[0].masked_fill(suppress, -1e9)
        token = int(torch.argmax(logits))
        if token == tk.codec_eos_token_id:
            return Trace(tokens, "eos", step)
        if step == max_new_tokens:
            break
        tokens.append(token)
        frame = _greedy_eager_subtalker(
            st_params, tk.code_predictor, talker_params["codec_embedding"],
            out.last_hidden[0], token,
        )
        emb = st_mod.embed_groups_sum(
            st_params, talker_params["codec_embedding"],
            torch.tensor([frame], dtype=torch.int64, device=device),
        )[0].float()
        emb = emb + (trailing[step] if step < trailing.shape[0] else tts_pad)
        embeds = torch.cat([embeds, emb[None]], dim=0)
    return Trace(tokens, "max_tokens", max_new_tokens)


def fast_greedy_trace(
    talker_params: dict,
    st_params: dict,
    cfg: TTSConfig,
    prompt: Prompt,
    max_new_tokens: int,
) -> Trace:
    """The production decode path, greedy."""
    gp = GenerationParams(max_new_tokens=max_new_tokens).greedy()
    embeds, mask, trailing, _ = batch_prompts([prompt], bucket=1)
    out = generate_codes(
        talker_params, st_params, cfg.talker, embeds, mask, trailing,
        sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
        max_new_tokens=max_new_tokens, generator=None,
        # Token-trace comparison: keep all sampled cb0 tokens (the frame-level
        # truncation trim is a separate, frame-count concern).
        trim_last_on_budget=False,
    )
    n = int(out.num_gen[0])
    stopped = bool(out.stopped[0])
    tokens = [int(x) for x in out.codes[0, :n, 0].tolist()]
    return Trace(tokens, "eos" if stopped else "max_tokens",
                 n if stopped else max_new_tokens)


@dataclasses.dataclass
class ParityResult:
    ok: bool
    first_divergence: Optional[int]
    fast: Trace
    eager: Trace

    def report(self) -> str:
        lines = [
            f"fast  : stop={self.fast.stop_reason}@{self.fast.stop_step} "
            f"tokens={len(self.fast.tokens)}",
            f"eager : stop={self.eager.stop_reason}@{self.eager.stop_step} "
            f"tokens={len(self.eager.tokens)}",
        ]
        if self.ok:
            lines.append("PARITY OK — token-exact greedy match")
        else:
            lines.append(f"PARITY FAIL — first divergence at step "
                         f"{self.first_divergence}")
            i = self.first_divergence or 0
            lines.append(f"  fast [{i}:] = {self.fast.tokens[i:i+8]}")
            lines.append(f"  eager[{i}:] = {self.eager.tokens[i:i+8]}")
        return "\n".join(lines)


def check_parity(
    talker_params: dict,
    st_params: dict,
    cfg: TTSConfig,
    prompt: Prompt,
    max_new_tokens: int,
) -> ParityResult:
    fast = fast_greedy_trace(talker_params, st_params, cfg, prompt, max_new_tokens)
    eager = eager_greedy_trace(talker_params, st_params, cfg, prompt, max_new_tokens)
    first_div = None
    for i, (a, b) in enumerate(zip(fast.tokens, eager.tokens)):
        if a != b:
            first_div = i
            break
    if first_div is None and len(fast.tokens) != len(eager.tokens):
        first_div = min(len(fast.tokens), len(eager.tokens))
    ok = (
        first_div is None
        and fast.stop_reason == eager.stop_reason
        and fast.stop_step == eager.stop_step
    )
    return ParityResult(ok, first_div, fast, eager)
