"""Per-row sampling controls for continuous batching (PyTorch counterpart of
``qwen_tts_tpu/ops/sampling_vec.py``).

The static ``SamplingConfig`` path (``ops/sampling.py``) fixes one set of
controls per captured program. A slot pool serves requests with different
controls at once, so here every control is a [B] tensor beside the decode
state, and one captured frame serves any mix of requests:

  do_sample / temperature / top_k / top_p / repetition_penalty /
  min_new_tokens, all per row.

Per-row top-k takes one descending sort and a per-row k-th threshold
(gather); top-p runs after the top-k mask over the filtered, sorted logits;
the draw is ``sample_token``'s exponential race from an explicit generator.
At rows that all hold one static config the tokens are ``sample_token``'s,
bit for bit, from the same generator state; a greedy row is the argmax of the
same processed logits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qwen_tts_tpu_torch.ops.sampling import NEG_INF, SamplingConfig, exponential_race

FIELDS = ("do_sample", "temperature", "top_k", "top_p", "repetition_penalty", "min_new_tokens")
_DTYPES = {"do_sample": torch.bool, "temperature": torch.float32, "top_k": torch.int32,
           "top_p": torch.float32, "repetition_penalty": torch.float32,
           "min_new_tokens": torch.int32}


@dataclasses.dataclass
class VecSampling:
    """Per-row sampling controls, each a [B] tensor."""

    do_sample: torch.Tensor           # bool
    temperature: torch.Tensor         # f32
    top_k: torch.Tensor               # int32 (0 = disabled)
    top_p: torch.Tensor               # f32 (>= 1 = disabled)
    repetition_penalty: torch.Tensor  # f32
    min_new_tokens: torch.Tensor      # int32

    @classmethod
    def broadcast(cls, cfg: SamplingConfig, b: int, device=None) -> "VecSampling":
        """A static SamplingConfig lifted to [b] tensors on ``device``."""
        return cls(**{f: torch.full((b,), getattr(cfg, f), dtype=_DTYPES[f], device=device)
                      for f in FIELDS})

    @classmethod
    def host_row(cls, cfg: SamplingConfig) -> "VecSampling":
        """A batch-1 VecSampling on the host, to write into a pool's row
        (``set_rows``) with one small copy a field."""
        return cls.broadcast(cfg, 1)

    def set_row(self, row: int, cfg: SamplingConfig) -> "VecSampling":
        """Row ``row`` set to ``cfg``, in place; returns self."""
        return self.set_rows(row, VecSampling.host_row(cfg))

    def set_rows(self, row: int, src: "VecSampling") -> "VecSampling":
        """``src``'s rows written from ``row`` on, in place; returns self."""
        for f in FIELDS:
            dst = getattr(self, f)
            dst[row: row + getattr(src, f).shape[0]].copy_(getattr(src, f))
        return self

    def copy_(self, src: "VecSampling") -> "VecSampling":
        """Every row of ``src`` into self, in place; returns self."""
        for f in FIELDS:
            getattr(self, f).copy_(getattr(src, f))
        return self

    def buffer_like(self) -> "VecSampling":
        """Uninitialised tensors of the same shapes, dtypes and device."""
        return VecSampling(**{f: torch.empty_like(getattr(self, f)) for f in FIELDS})


def apply_repetition_penalty_vec(
    logits: torch.Tensor,    # [B, V] f32
    presence: torch.Tensor,  # [B, V] bool
    penalty: torch.Tensor,   # [B] f32
) -> torch.Tensor:
    p = penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(presence, penalized, logits)


def warp_vec(logits: torch.Tensor, vs: VecSampling) -> torch.Tensor:
    """[B, V] logits over each row's temperature, with the logits its top-k
    and then its top-p drop set to NEG_INF."""
    v = logits.shape[-1]
    warped = logits / vs.temperature.clamp(min=1e-5)[:, None]
    sorted_logits = torch.sort(warped, dim=-1, descending=True).values

    # Per-row top-k: keep every logit >= the k-th largest, ties included.
    top_k = vs.top_k.long()
    k = torch.where((top_k > 0) & (top_k < v), top_k, v)
    kth = sorted_logits.gather(-1, (k - 1)[:, None])
    warped = warped.masked_fill(warped < kth, NEG_INF)

    # Per-row top-p after the top-k mask: the softmax runs over the top-k
    # filtered, sorted logits, as the static chain does.
    positions = torch.arange(v, device=logits.device)
    sorted_k = sorted_logits.masked_fill(positions[None, :] >= k[:, None], NEG_INF)
    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < vs.top_p[:, None]
    kept = keep_sorted.sum(dim=-1, keepdim=True).clamp(min=1)
    cutoff = sorted_k.gather(-1, kept - 1)
    apply_p = (vs.top_p < 1.0)[:, None]
    return warped.masked_fill(apply_p & (warped < cutoff), NEG_INF)


def sample_token_vec(
    logits: torch.Tensor,  # [B, V] f32, suppress/penalty already applied
    vs: VecSampling,
    generator: Optional[torch.Generator],
    race: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B] int64 tokens: each row sampled under its own controls, or its
    argmax where ``do_sample`` is off. Always draws one exponential race of
    [B, V] from ``generator``, whatever the rows ask, unless ``race`` gives
    one drawn beforehand."""
    probs = torch.softmax(warp_vec(logits, vs), dim=-1)
    if race is None:
        race = exponential_race(probs.shape, generator, probs.device)
    return torch.where(vs.do_sample, (probs / race).argmax(dim=-1), logits.argmax(dim=-1))
