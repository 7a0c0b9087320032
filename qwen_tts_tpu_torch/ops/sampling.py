"""Logits processing and sampling (PyTorch counterpart of
``qwen_tts_tpu/ops/sampling.py``).

Suppress mask, repetition penalty over a vocab presence mask, temperature,
top-k and top-p, then a categorical draw from an explicit
``torch.Generator`` (an exponential race, which a CUDA graph can capture).
``torch.Generator`` and ``jax.random`` give different numbers from one seed,
so sampled traces agree with the JAX package only in their semantics;
greedy decoding is an argmax over identically processed logits and agrees
token for token.

A division by a control (temperature, repetition penalty) divides by a
tensor on the logits' device: on the card PyTorch turns a division by a
Python number into a product with its reciprocal, which can differ in the
last bit, and the per-row path (``ops/sampling_vec.py``) must give these
bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from qwen_tts_tpu_torch.config import placement_of

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    do_sample: bool = True
    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.05
    min_new_tokens: int = 0

    def greedy(self) -> "SamplingConfig":
        return dataclasses.replace(self, do_sample=False)


def apply_suppress_mask(logits: torch.Tensor, suppress: torch.Tensor) -> torch.Tensor:
    """suppress: [V] bool, True = banned (set to -1e9)."""
    return logits.masked_fill(suppress, NEG_INF)


def apply_repetition_penalty(
    logits: torch.Tensor,    # [B, V] float32
    presence: torch.Tensor,  # [B, V] bool — token seen in the generated history
    penalty: float,
) -> torch.Tensor:
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / _divisor(logits, penalty), logits * penalty)
    return torch.where(presence, penalized, logits)


def _divisor(logits: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a [1, 1] tensor on the logits' device (a fill, which a
    CUDA graph capture takes)."""
    return logits.new_full((1, 1), value)


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keeps every logit >= the k-th largest, ties included."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens while the mass *before* them is < top_p (HF
    # TopPLogitsWarper semantics; the top token always stays).
    keep_sorted = (cum - probs) < top_p
    kept = keep_sorted.sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, kept - 1)
    return logits.masked_fill(logits < cutoff, NEG_INF)


def draw_rows(cfg, batch: int) -> Optional[Tuple[int, int]]:
    """(first row, global rows) of a dp rank's ``batch`` rows in the global
    batch, from the placement of ``cfg`` (a talker or code-predictor config;
    ``parallel/mesh.py``); None off a dp mesh. Every dp rank shards the
    global batch evenly (``shard_rows``)."""
    placement = placement_of(cfg)
    if placement is None or placement.dp_size == 1:
        return None
    return placement.dp_rank * batch, placement.dp_size * batch


def exponential_race(shape, generator: Optional[torch.Generator], device,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """E ~ Exp(1) per entry, f32, drawn from ``generator``: the noise of an
    exponential race (``sample_token``'s ``race``). With ``rows`` (first,
    global; ``draw_rows``) the batch axis (-2) is a dp rank's rows: the
    global batch's races are drawn and the rank's kept, so the ranks of a
    dp mesh draw what one device draws for the whole batch."""
    if rows is None:
        return torch.empty(shape, dtype=torch.float32, device=device).exponential_(
            generator=generator)
    first, total = rows
    full = list(shape)
    full[-2] = total
    race = torch.empty(full, dtype=torch.float32, device=device).exponential_(
        generator=generator)
    return race.narrow(-2, first, shape[-2])


def sample_token(
    logits: torch.Tensor,  # [B, V] float32, already suppress/penalty-processed
    cfg: SamplingConfig,
    generator: Optional[torch.Generator],
    race: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns [B] int64 token ids. ``generator`` lives on the logits' device
    and is only read when sampling.

    The draw is an exponential race, argmax of p / E with E ~ Exp(1) drawn
    per entry: the categorical draw ``torch.multinomial(probs, 1)`` makes
    (the same numbers from the same generator), written out so that no host
    check of the probabilities runs and the draw can be captured in a CUDA
    graph. ``race`` [B, V] gives E drawn beforehand (``exponential_race``),
    and the generator is then not read."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    warped = logits / _divisor(logits, max(cfg.temperature, 1e-5))
    warped = _top_k_filter(warped, cfg.top_k)
    warped = _top_p_filter(warped, cfg.top_p)
    probs = torch.softmax(warped, dim=-1)
    if race is None:
        race = exponential_race(probs.shape, generator, probs.device)
    return (probs / race).argmax(dim=-1)


def build_suppress_mask(vocab_size: int, eos_id: int, tail: int = 1024,
                        device=None) -> torch.Tensor:
    """Bans the last ``tail`` vocab entries except EOS."""
    ids = torch.arange(vocab_size, device=device)
    return (ids >= vocab_size - tail) & (ids != eos_id)
