"""The comparison that decides ``correct``: what the timed path served,
held against the plain reference (``model.py``).

For every request of the check's sample (requests that the window finished:
greedy and sampled ones, from both halves of the slot pool or of the batch),
the reference runs once over the prompt and the served codes,
teacher-forced, and reads five numbers:

* ``talker_gap``: over the greedy requests, the widest gap by which a served
  group-0 code's logit lies below the reference's best, the sampler's
  processing applied (the banned tail, the EOS ban, the repetition penalty);
* ``subtalker_gap``: the same for the served codes of groups 1..G-1;
* ``talker_topk_gap`` and ``subtalker_topk_gap``: over the sampled requests,
  the widest gap by which a served code's logit lies below the reference's
  k-th best (k the request's top-k), so a code sampled outside the
  reference's top k shows;
* ``codec_err``: the largest difference between a served waveform sample
  and the reference's, decoded over the same windows (a stream's windows,
  or a batch's chunks).

The control puts the reference in the program's place at the precision
below the configuration's, and reads at each position the gap of the code
it would put first (greedy requests) or would sample from its own top k with
the request's temperature (sampled requests), and the difference of its own
waveform.

It imports nothing of the program: the requests hold token ids, codes and
audio, and the weights are the benchmark's seeded inputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference.model import (SERVING_INT8, Precision, chunk_spans, codec_decode, gap_of,
                             kth_gap_of, request_logits, stream_windows)

NAMES = ("talker_gap", "subtalker_gap", "talker_topk_gap", "subtalker_topk_gap",
         "codec_err")


def precisions(mode: dict) -> Dict[str, Precision]:
    """The configuration's own precision and the control's. ``mode``:
    ``int8`` (the serving mode's weights are int8), ``codec_dtype``."""
    int8 = SERVING_INT8 if mode["int8"] else ()
    # The serving mode keeps the talker's KV cache as int8 per token and
    # head; the reference rounds its keys and values the same way.
    own = Precision(int8=int8, kv_levels=127.0 if mode["int8"] else None)
    if mode["int8"]:
        # int8 weights and cache step down to int4; the bf16 weights to fp8.
        control_model = Precision(int8=int8, int_levels=7.0, fp8_weights=True, kv_levels=7.0)
    else:
        control_model = Precision(fp8=True)
    control_codec = (Precision(fp8=True) if mode["codec_dtype"] == "bfloat16"
                     else _Bf16())
    return {"own": own, "control_model": control_model, "control_codec": control_codec}


class _Bf16(Precision):
    """f32 stepped down to bf16: every weight and every product's input
    rounded to bf16."""

    def weight(self, name, w):
        key = id(w)
        if key not in self._cache:
            self._cache[key] = w.to(torch.bfloat16).float()
        return self._cache[key]

    def mm(self, x, name, w):
        return x.to(torch.bfloat16).float() @ self.weight(name, w)

    def conv_in(self, x):
        return x.to(torch.bfloat16).float()


def sample_top_k(logits: torch.Tensor, k: int, temperature: float,
                 gen: torch.Generator) -> torch.Tensor:
    """A code drawn from each row's top ``k`` of ``logits`` [..., V] at
    ``temperature``."""
    flat = logits.reshape(-1, logits.shape[-1]) / temperature
    top = flat.topk(k, dim=-1)
    pick = torch.multinomial(top.values.softmax(-1), 1, generator=gen)
    return top.indices.gather(-1, pick)[:, 0].reshape(logits.shape[:-1])


def codec_reference(p: Precision, cw: dict, cfg: dict, item: dict, q: int) -> np.ndarray:
    """The reference's waveform of one request's codes, over the windows
    the program decoded them in."""
    dev = cw["codebooks"].device
    codes = torch.as_tensor(np.asarray(item["codes"])[:, :q], dtype=torch.long, device=dev)
    c = item["codec"]
    up = cfg["speech_tokenizer"]["decode_upsample_rate"]
    if c["mode"] == "stream":
        windows, cuts = stream_windows(codes, c["chunks"], c["context"], c["segment"])
        wav = codec_decode(p, cw, cfg, windows)
        parts = [wav[k, ctx * up:(ctx + fresh) * up] for k, (ctx, fresh) in enumerate(cuts)]
        return torch.cat(parts).cpu().numpy()
    t_max = c["t_max"]
    padded = torch.zeros((1, t_max, q), dtype=torch.long, device=dev)
    padded[0, : codes.shape[0]] = codes
    parts = []
    for start, end, ctx in chunk_spans(t_max, c["chunk"], c["context"]):
        wav = codec_decode(p, cw, cfg, padded[:, start - ctx: end])
        parts.append(wav[0, ctx * up:])
    return torch.cat(parts)[: codes.shape[0] * up].cpu().numpy()


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def readings(weights: dict, cfg: dict, sample: List[dict], mode: dict,
             control: bool = False) -> Dict[str, float]:
    """The numbers over ``sample``: the program's (``control=False``) or
    the control's."""
    ps = precisions(mode)
    q = cfg["speech_tokenizer"]["decoder_config"]["num_quantizers"]
    out = {k: 0.0 for k in NAMES}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), _no_tf32():
            for n, req in enumerate(sample):
                talker, sub = request_logits(ps["own"], weights, cfg, req)
                codes = torch.as_tensor(np.asarray(req["codes"]), dtype=torch.long,
                                        device=talker.device)
                greedy = req["greedy"]
                if control:
                    c_talker, c_sub = request_logits(ps["control_model"], weights, cfg, req)
                    if greedy:
                        chosen0, chosen = c_talker.argmax(-1), c_sub.argmax(-1)
                    else:
                        gen = torch.Generator(device=talker.device).manual_seed(n)
                        chosen0 = sample_top_k(c_talker, req["top_k"], req["temperature"], gen)
                        chosen = sample_top_k(c_sub, req["subtalker_top_k"],
                                              req["subtalker_temperature"], gen)
                else:
                    chosen0, chosen = codes[:, 0], codes[:, 1:]
                if greedy:
                    gaps = (("talker_gap", gap_of(talker, chosen0)),
                            ("subtalker_gap", gap_of(sub, chosen)))
                else:
                    gaps = (("talker_topk_gap", kth_gap_of(talker, chosen0, req["top_k"])),
                            ("subtalker_topk_gap",
                             kth_gap_of(sub, chosen, req["subtalker_top_k"])))
                for name, gap in gaps:
                    out[name] = max(out[name], float(gap.max()))
                ref = codec_reference(ps["own"], weights["codec"], cfg, req, q)
                if control:
                    other = codec_reference(ps["control_codec"], weights["codec"], cfg, req, q)
                else:
                    other = np.asarray(req["audio"], np.float32)
                if other.shape != ref.shape:
                    out["codec_err"] = 1e9  # the lengths differ
                else:
                    out["codec_err"] = max(out["codec_err"],
                                           float(np.abs(other - ref).max(initial=0.0)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    return out
