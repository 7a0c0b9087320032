"""The one traffic generator: every mix is a parameter file
(``traffic/<name>.json``) that this module reads.

Lengths are drawn by stratified sampling, so that the mix of sizes is the
same from seed to seed and only their order, the ids and the voices change:
each block of ``block`` requests takes the ``block`` quantile midpoints of a
clipped log-normal, in an order the seed permutes. Open-loop arrivals are
stratified the same way: the gaps between them are blocks of the quantile
midpoints of an exponential at the rate (the cell's, laid over its mix), in
a seeded order, so a span of a given length always holds the same number of
requests.

A request is a dict: ``text_ids`` (the chat-templated id sequence),
``speaker``, ``language``, ``frames`` (audio frames to serve), ``greedy``,
``seed`` and, in an open loop, ``due`` (seconds from the window's start;
negative during the ramp).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream]))


def lognormal_midpoints(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The ``n`` quantile midpoints of a log-normal, rounded and clipped."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def exponential_midpoints(n: int, rate: float) -> np.ndarray:
    """The ``n`` quantile midpoints of an exponential of ``rate`` per second."""
    return np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])


def voices(cfg: dict) -> List[tuple]:
    t = cfg["talker_config"]
    return [(s, l) for s in sorted(t["spk_id"]) for l in sorted(t["codec_language_id"])]


def text_ids(gen: np.random.Generator, cfg: dict, n_tokens: int) -> List[int]:
    """The chat template around ``n_tokens`` ordinary text tokens:
    <|im_start|>assistant\\n TEXT <|im_end|>\\n<|im_start|>assistant\\n."""
    tpl = cfg["text_template"]
    start, end = cfg["im_start_token_id"], cfg["im_end_token_id"]
    role, nl = tpl["assistant_token_id"], tpl["newline_token_id"]
    body = gen.integers(0, tpl["ordinary_text_tokens"], size=n_tokens).tolist()
    return [start, role, nl] + body + [end, nl, start, role, nl]


def block(mix: dict, cfg: dict, seed: int, index: int) -> List[Dict]:
    """Block ``index`` of the mix's requests: ``mix["block"]`` of them."""
    n = mix["block"]
    gen = rng(seed, 1, index)
    frames = lognormal_midpoints(n, **mix["frames"])[gen.permutation(n)]
    tokens = lognormal_midpoints(n, **mix["text_tokens"])[gen.permutation(n)]
    greedy = np.zeros(n, bool)
    greedy[gen.permutation(n)[: mix.get("greedy_per_block", 0)]] = True
    vs = voices(cfg)
    order = gen.permutation(n)
    out = []
    for i in range(n):
        speaker, language = vs[order[i] % len(vs)]
        out.append({"text_ids": text_ids(gen, cfg, int(tokens[i])), "speaker": speaker,
                    "language": language, "frames": int(frames[i]), "greedy": bool(greedy[i]),
                    "seed": int(gen.integers(0, 2 ** 31 - 1))})
    return out


def _arrivals(mix: dict, seed: int, stream: int, start: float, span: float) -> List[float]:
    """``round(rate x span)`` due times in [start, start + span): gaps that
    are each block's exponential midpoints in a seeded order, scaled so that
    one gap more would end the span. The count is the same for every seed."""
    n = int(round(mix["rate"] * span))
    gaps: List[float] = []
    index = 0
    while len(gaps) < n + 1:
        block = exponential_midpoints(mix["block"], mix["rate"])
        gaps += block[rng(seed, stream, index).permutation(mix["block"])].tolist()
        index += 1
    cum = np.cumsum(gaps[: n + 1])
    return [start + span * float(c) / float(cum[-1]) for c in cum[:n]]


def schedule(mix: dict, cfg: dict, seed: int, seconds: float) -> List[Dict]:
    """An open loop: the ramp's requests due in [-ramp_s, 0) and the
    window's in [0, seconds), each at ``mix["rate"]`` per second, with its
    ``due`` time. The window's requests come from blocks 0, 1, ... of the
    mix, the ramp's from blocks of their own."""
    out = []
    for stream, start, span, first in ((2, -float(mix["ramp_s"]), float(mix["ramp_s"]), 10 ** 5),
                                       (3, 0.0, float(seconds), 0)):
        due = _arrivals(mix, seed, stream, start, span)
        reqs: List[Dict] = []
        index = first
        while len(reqs) < len(due):
            reqs += block(mix, cfg, seed, index)
            index += 1
        for r, t in zip(reqs, due):
            r["due"] = t
            out.append(r)
    return out


def calls(mix: dict, cfg: dict, seed: int, index: int) -> Dict:
    """A closed loop's call ``index``: one block of rows, greedy every
    ``mix["greedy_every"]``-th call (from the first)."""
    return {"rows": block(mix, cfg, seed, index),
            "greedy": index % mix["greedy_every"] == 0}
