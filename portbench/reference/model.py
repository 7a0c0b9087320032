"""The plain reference of a 12 Hz Qwen3-TTS model: the talker, the
sub-talker and the codec decoder in straightforward PyTorch, from the
published layer equations (QwenLM/Qwen3-TTS ``modeling_qwen3_tts.py`` and the
12 Hz tokenizer's decoder).

It imports neither ``jax`` nor anything of the program under test. It reads
the benchmark's seeded weights (dicts of tensors in the layout the benchmark
made them in) and the configuration file, and works out again whatever the
program derives from them: the int8 weights and their scales of the serving
mode, and the prompt's embeddings. It has no cache: the talker runs the whole
teacher-forced sequence at once, the sub-talker every frame's sixteen
positions at once.

Every product goes through ``Precision.mm``, so one reference gives the
numbers at the configuration's own precision (f32 arithmetic on the deployed
weights) and at the control's lower one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def _channel_scale(w: torch.Tensor, levels: float) -> torch.Tensor:
    """Symmetric scale per output column of a [..., in, out] weight."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    return torch.clamp_min(amax / torch.full_like(amax, levels), 1e-8)


def int_weight(w: torch.Tensor, levels: float) -> torch.Tensor:
    """``w`` [..., in, out] through symmetric integer quantization per
    output column (round half to even), dequantized with the scale rounded
    to bf16, as the serving mode stores it: int8 at 127 levels, int4 at 7."""
    w = w.float()
    scale = _channel_scale(w, levels)
    q = torch.round(w / scale).clamp(-levels, levels)
    return q * scale.to(torch.bfloat16).float()


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` [..., in, out] through float8 e4m3 with a scale per output
    column."""
    w = w.float()
    scale = _channel_scale(w, F8_MAX)
    return (w / scale).to(F8).float() * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Activations [..., K] through float8 e4m3 with a scale per row."""
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / F8_MAX, 1e-12)
    return (x / scale).to(F8).float() * scale


class Precision:
    """How the reference holds each weight and each product's input.

    ``int8``: the names of the weights the configuration serves as int8
    (per output column); ``int_levels`` 127 gives the configuration's own
    int8, 7 the control's int4. ``fp8``: the other weights and every
    product's input go through float8 e4m3 (the control of a bf16
    configuration). ``kv_levels``: the talker's keys and values, as a decode
    step reads them from its cache, through symmetric integer quantization
    per token and head (127: the serving mode's int8 cache; 7: int4); None
    for a float cache. Arithmetic is f32 without TF32 either way."""

    def __init__(self, int8: Sequence[str] = (), int_levels: float = 127.0,
                 fp8: bool = False, fp8_weights: bool = False,
                 kv_levels: Optional[float] = None):
        self.int8 = set(int8)
        self.kv_levels = kv_levels
        self.int_levels = int_levels
        self.fp8 = fp8
        self.fp8_weights = fp8_weights or fp8
        self._cache: Dict[int, torch.Tensor] = {}

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        key = id(w)
        if key not in self._cache:
            if name in self.int8:
                out = int_weight(w, self.int_levels)
            elif self.fp8_weights and w.dim() >= 2:
                out = fp8_weight(w)
            else:
                out = w.float()
            self._cache[key] = out
        return self._cache[key]

    def mm(self, x: torch.Tensor, name: str, w: torch.Tensor) -> torch.Tensor:
        x = fp8_rows(x) if self.fp8 else x.float()
        return x @ self.weight(name, w)

    def conv_in(self, x: torch.Tensor) -> torch.Tensor:
        """A convolution's input [B, T, C] (rows are time steps)."""
        return fp8_rows(x) if self.fp8 else x.float()


# --------------------------------------------------------------------------
# The transformer block shared by the talker, the sub-talker and the codec
# --------------------------------------------------------------------------

def int_rows(x: torch.Tensor, levels: float) -> torch.Tensor:
    """``x`` [..., hd] through symmetric integer quantization per vector
    over its last axis (scale max(amax / levels, 1e-8) in f32, round half to
    even), dequantized."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, levels), 1e-8)
    return torch.round(x / scale).clamp(-levels, levels) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on x [B, S, H, hd] at integer positions [S]. Text-only
    speech carries three equal M-RoPE position streams, so the talker's
    M-RoPE is this one."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions.float()[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention: q [B, S, H, hd], k/v [B, S, KV, hd]."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)
    allowed = i[None, :] <= i[:, None]
    if window is not None:
        allowed = allowed & (i[None, :] > i[:, None] - window)
    scores = scores.masked_fill(~allowed, float("-inf"))
    return torch.einsum("bhij,bjhd->bihd", scores.softmax(-1), v)


def block_stack(p: Precision, prefix: str, trunk: dict, h: torch.Tensor, *,
                heads: int, kv_heads: int, head_dim: int, eps: float, theta: float,
                window: Optional[int] = None, cached_from: Optional[int] = None
                ) -> torch.Tensor:
    """Pre-norm decoder layers over h [B, S, D]: attention with optional
    per-head QK-RMSNorm, SwiGLU, optional LayerScale on both branches. The
    queries from position ``cached_from`` on are decode steps: with
    ``p.kv_levels`` they read every key and value through the cache's
    integer rounding (the prefill's queries before it read them as they
    are)."""
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)
    # Each stacked weight [L, in, out] is held once (its scales per layer
    # and output column), then taken layer by layer.
    mats = {k: p.weight(f"{prefix}.{k}", trunk[k])
            for k in ("wq", "wk", "wv", "wo", "gate", "up", "down")}

    def mm(x, key, l):
        return (fp8_rows(x) if p.fp8 else x.float()) @ mats[key][l]

    for l in range(trunk["wq"].shape[0]):
        x = rms_norm(h, trunk["input_norm"][l], eps)
        q = mm(x, "wq", l).unflatten(-1, (heads, head_dim))
        k = mm(x, "wk", l).unflatten(-1, (kv_heads, head_dim))
        v = mm(x, "wv", l).unflatten(-1, (kv_heads, head_dim))
        if "q_norm" in trunk:
            q = rms_norm(q, trunk["q_norm"][l], eps)
            k = rms_norm(k, trunk["k_norm"][l], eps)
        q, k = rope(q, positions, theta), rope(k, positions, theta)
        att = attention(q, k, v, window)
        if cached_from is not None and p.kv_levels is not None:
            cached = attention(q, int_rows(k, p.kv_levels), int_rows(v, p.kv_levels), window)
            att = torch.cat([att[:, :cached_from], cached[:, cached_from:]], dim=1)
        a = mm(att.flatten(-2), "wo", l)
        if "attn_scale" in trunk:
            a = a * trunk["attn_scale"][l].float()
        h = h + a
        x = rms_norm(h, trunk["post_attn_norm"][l], eps)
        m = mm(F.silu(mm(x, "gate", l)) * mm(x, "up", l), "down", l)
        if "mlp_scale" in trunk:
            m = m * trunk["mlp_scale"][l].float()
        h = h + m
    return h


# Weights that the serving mode holds as int8 (per output column).
SERVING_INT8 = tuple(f"{part}.{k}" for part in ("talker", "subtalker")
                     for k in ("wq", "wk", "wv", "wo", "gate", "up", "down")) + (
    "subtalker.embeds", "subtalker.lm_heads")


# --------------------------------------------------------------------------
# Talker and sub-talker
# --------------------------------------------------------------------------

def _text(p: Precision, tk: dict, ids: torch.Tensor) -> torch.Tensor:
    """The text track: the text embedding through the 2-layer SiLU projection."""
    x = tk["text_embedding"][ids].float()
    x = F.silu(p.mm(x, "talker.text_proj_fc1", tk["text_proj_fc1"])
               + tk["text_proj_fc1_b"].float())
    return p.mm(x, "talker.text_proj_fc2", tk["text_proj_fc2"]) + tk["text_proj_fc2_b"].float()


def prompt_embeds(p: Precision, tk: dict, cfg: dict, text_ids: Sequence[int],
                  speaker: str, language: str):
    """The streaming custom-voice prompt of one request: (prefix [S, D],
    trailing text [T, D], tts_pad [D]). ``text_ids`` is the chat-templated
    sequence ``[im_start, assistant, \\n, TEXT..., im_end, \\n, im_start,
    assistant, \\n]``; the role header and the first text token lead, the
    rest of the text trails in, one token a frame."""
    t = cfg["talker_config"]
    dev = tk["codec_embedding"].device

    def ids(x):
        return torch.as_tensor(list(x), dtype=torch.long, device=dev)

    def codec(x):
        return tk["codec_embedding"][ids(x)].float()

    bos, eos, pad = _text(p, tk, ids([cfg["tts_bos_token_id"], cfg["tts_eos_token_id"],
                                      cfg["tts_pad_token_id"]]))
    lang = t["codec_language_id"][language]
    prefix = torch.cat([codec([t["codec_think_id"], t["codec_think_bos_id"], lang,
                               t["codec_think_eos_id"], t["spk_id"][speaker],
                               t["codec_pad_id"], t["codec_bos_id"]])])
    n = prefix.shape[0]
    text = _text(p, tk, ids(text_ids))
    track = torch.cat([pad[None].expand(n - 2, -1), bos[None]])
    embeds = torch.cat([text[:3], track + prefix[:-1], text[3:4] + prefix[-1:]])
    trailing = torch.cat([text[4:-5], eos[None]])
    return embeds, trailing, pad


def talker_forward(p: Precision, tk: dict, cfg: dict, embeds: torch.Tensor,
                   prefill: int):
    """The talker over inputs [S, D], the first ``prefill`` of them the
    prompt's prefill and the rest decode steps through the cache:
    (post-norm hidden [S, D], logits [S, V])."""
    t = cfg["talker_config"]
    h = block_stack(p, "talker", tk["trunk"], embeds[None], heads=t["num_attention_heads"],
                    kv_heads=t["num_key_value_heads"], head_dim=t["head_dim"],
                    eps=t["rms_norm_eps"], theta=t["rope_theta"], cached_from=prefill)[0]
    h = rms_norm(h, tk["norm"], t["rms_norm_eps"])
    return h, p.mm(h, "talker.codec_head", tk["codec_head"])


def subtalker_embed(p: Precision, st: dict, group: int, codes: torch.Tensor) -> torch.Tensor:
    """Rows ``codes`` of group table ``group`` (0-based over groups 1..G-1)."""
    table = p.weight("subtalker.embeds", st["embeds"])[group]
    return table[codes]


def frame_inputs(p: Precision, tk: dict, st: dict, codes: torch.Tensor) -> torch.Tensor:
    """The talker's input of each frame [F, D]: the sum of its G group
    embeddings (group 0 from the talker's codec table)."""
    x = tk["codec_embedding"][codes[:, 0]].float()
    for g in range(1, codes.shape[1]):
        x = x + subtalker_embed(p, st, g - 1, codes[:, g])
    return x


def subtalker_logits(p: Precision, tk: dict, st: dict, cfg: dict, hidden: torch.Tensor,
                     codes: torch.Tensor) -> torch.Tensor:
    """Teacher-forced sub-talker: the logits [F, G-1, V_st] of groups
    1..G-1 of each frame, from the talker's post-norm hidden [F, D] at the
    position that chose the frame's group-0 code, and the frame's codes."""
    c = cfg["talker_config"]["code_predictor_config"]
    g = codes.shape[1]
    seq = [hidden.float(), tk["codec_embedding"][codes[:, 0]].float()]
    seq += [subtalker_embed(p, st, k - 2, codes[:, k - 1]) for k in range(2, g)]
    x = torch.stack(seq, dim=1)  # [F, G, D]
    if "input_proj" in st:
        x = p.mm(x, "subtalker.input_proj", st["input_proj"]) + st["input_proj_b"].float()
    h = block_stack(p, "subtalker", st["trunk"], x, heads=c["num_attention_heads"],
                    kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
                    eps=c["rms_norm_eps"], theta=c["rope_theta"])
    h = rms_norm(h, st["norm"], c["rms_norm_eps"])
    heads = p.weight("subtalker.lm_heads", st["lm_heads"])
    xs = fp8_rows(h[:, 1:]) if p.fp8 else h[:, 1:]
    return torch.einsum("fgd,gdv->fgv", xs, heads)


def process_talker(logits: torch.Tensor, cfg: dict, codes0: torch.Tensor,
                   penalty: float, min_new: int) -> torch.Tensor:
    """The logits of each group-0 code [F, V] as the sampler sees them:
    the banned tail (all but EOS), EOS banned before ``min_new`` codes, the
    repetition penalty over the codes already chosen."""
    t = cfg["talker_config"]
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)
    eos = t["codec_eos_token_id"]
    out = logits.masked_fill((ids >= v - t["suppress_tail"]) & (ids != eos), float("-inf"))
    n = torch.arange(out.shape[0], device=out.device)
    out = out.masked_fill((n < min_new)[:, None] & (ids == eos)[None], float("-inf"))
    seen = torch.zeros_like(out, dtype=torch.bool)
    for i in range(1, out.shape[0]):
        seen[i] = seen[i - 1]
        seen[i, codes0[i - 1]] = True
    penalized = torch.where(out > 0, out / penalty, out * penalty)
    return torch.where(seen, penalized, out)


def request_logits(p: Precision, weights: dict, cfg: dict, req: dict):
    """The reference's logits for one served request: (talker [F, V]
    processed as the sampler sees them, sub-talker [F, G-1, V_st]), F the
    served frames. ``req`` holds the prompt (``text_ids``, ``speaker``,
    ``language``), the sampler's ``repetition_penalty`` and
    ``min_new_tokens`` and the served ``codes`` [F, G]."""
    tk, st = weights["talker"], weights["subtalker"]
    codes = torch.as_tensor(req["codes"], dtype=torch.long, device=tk["norm"].device)
    embeds, trailing, pad = prompt_embeds(p, tk, cfg, req["text_ids"], req["speaker"],
                                          req["language"])
    f = codes.shape[0]
    rows = torch.arange(f - 1, device=codes.device)
    text = torch.where((rows < trailing.shape[0])[:, None],
                       trailing[rows.clamp(max=trailing.shape[0] - 1)], pad[None])
    seq = torch.cat([embeds, frame_inputs(p, tk, st, codes[:-1]) + text])
    s = embeds.shape[0]
    hidden, logits = talker_forward(p, tk, cfg, seq, s)
    hidden, logits = hidden[s - 1: s - 1 + f], logits[s - 1: s - 1 + f]
    talker = process_talker(logits, cfg, codes[:, 0], req["repetition_penalty"],
                            req["min_new_tokens"])
    return talker, subtalker_logits(p, tk, st, cfg, hidden, codes)


def gap_of(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the best."""
    return logits.max(dim=-1).values - logits.gather(-1, chosen[..., None])[..., 0]


def kth_gap_of(logits: torch.Tensor, chosen: torch.Tensor, k: int) -> torch.Tensor:
    """How far each chosen token's logit lies below the k-th best (at most
    0 for a token inside the top k)."""
    kth = logits.topk(k, dim=-1).values[..., -1]
    return kth - logits.gather(-1, chosen[..., None])[..., 0]


# --------------------------------------------------------------------------
# Codec decoder
# --------------------------------------------------------------------------

def causal_conv(p: Precision, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x [B, T, C_in], w [K, C_in / groups, C_out] → [B, T, C_out], left-padded."""
    k = w.shape[0]
    wt = p.weight("codec.conv", w).permute(2, 1, 0)
    xc = F.pad(p.conv_in(x).transpose(1, 2), ((k - 1) * dilation, 0))
    return F.conv1d(xc, wt, b.float(), dilation=dilation, groups=groups).transpose(1, 2)


def causal_tconv(p: Precision, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """Transposed conv with the flipped-tap weight [K, C_in, C_out] (tap j
    holds the published kernel's tap K-1-j), trimmed on the right to
    T * stride."""
    k = w.shape[0]
    wt = torch.flip(p.weight("codec.tconv", w), dims=(0,)).permute(1, 2, 0)
    out = F.conv_transpose1d(p.conv_in(x).transpose(1, 2), wt, b.float(), stride=stride)
    if k > stride:
        out = out[..., : out.shape[-1] - (k - stride)]
    return out.transpose(1, 2)


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta with alpha and beta already exponentiated."""
    return x + torch.sin(x * alpha.float()).square() / (beta.float() + 1e-9)


def codec_decode(p: Precision, cw: dict, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, Q] → waveform [B, T * upsample], clamped to [-1, 1]."""
    dec = cfg["speech_tokenizer"]["decoder_config"]
    books = cw["codebooks"].float()
    codes = codes.clamp(min=0).long()
    h = sum(books[q][codes[..., q]] for q in range(books.shape[0]))
    h = causal_conv(p, h, cw["pre_conv_w"], cw["pre_conv_b"])
    tr = cw["transformer"]
    h = p.mm(h, "codec.input_proj", tr["input_proj_w"]) + tr["input_proj_b"].float()
    heads = dec["num_attention_heads"]
    h = block_stack(p, "codec", tr["trunk"], h, heads=heads,
                    kv_heads=dec["num_key_value_heads"],
                    head_dim=dec["hidden_size"] // heads, eps=dec["rms_norm_eps"],
                    theta=dec["rope_theta"], window=dec["sliding_window"])
    h = rms_norm(h, tr["norm"], dec["rms_norm_eps"])
    h = p.mm(h, "codec.output_proj", tr["output_proj_w"]) + tr["output_proj_b"].float()
    for stage, factor in zip(cw["upsample"], dec["upsampling_ratios"]):
        h = causal_tconv(p, h, stage["tconv_w"], stage["tconv_b"], factor)
        c = stage["convnext"]
        r = causal_conv(p, h, c["dw_w"], c["dw_b"], groups=h.shape[-1])
        r = F.layer_norm(r, (r.shape[-1],), c["ln_w"].float(), c["ln_b"].float(), eps=1e-6)
        r = F.gelu(p.mm(r, "codec.pw1", c["pw1_w"]) + c["pw1_b"].float())
        r = p.mm(r, "codec.pw2", c["pw2_w"]) + c["pw2_b"].float()
        h = h + c["gamma"].float() * r
    h = causal_conv(p, h, cw["vocoder_pre_w"], cw["vocoder_pre_b"])
    for block, rate in zip(cw["blocks"], dec["upsample_rates"]):
        h = snake(h, block["alpha"], block["beta"])
        h = causal_tconv(p, h, block["tconv_w"], block["tconv_b"], rate)
        for unit, dilation in zip(block["resunits"], (1, 3, 9)):
            r = snake(h, unit["alpha1"], unit["beta1"])
            r = causal_conv(p, r, unit["conv1_w"], unit["conv1_b"], dilation=dilation)
            r = snake(r, unit["alpha2"], unit["beta2"])
            h = h + causal_conv(p, r, unit["conv2_w"], unit["conv2_b"])
    h = snake(h, cw["final_alpha"], cw["final_beta"])
    return causal_conv(p, h, cw["final_conv_w"], cw["final_conv_b"])[..., 0].clamp(-1, 1)


def stream_windows(codes: torch.Tensor, chunk_frames: List[int], context: int,
                   segment: int):
    """The codec windows behind a stream's chunks: for chunk k of
    ``chunk_frames[k]`` new frames, the left context (at most ``context``
    frames already emitted) and the new frames, right-padded with code 0 to
    ``context + segment`` frames. Returns (windows [K, W, Q], the (first,
    frames) of each chunk's audio in its window)."""
    windows, cuts = [], []
    done = 0
    for fresh in chunk_frames:
        ctx = min(context, done)
        w = torch.zeros((context + segment, codes.shape[1]), dtype=torch.long,
                        device=codes.device)
        w[: ctx + fresh] = codes[done - ctx: done + fresh]
        windows.append(w)
        cuts.append((ctx, fresh))
        done += fresh
    return torch.stack(windows), cuts


def chunk_spans(t: int, chunk: int, context: int):
    """The (start, end, context) of each codec chunk over ``t`` frames."""
    spans, start = [], 0
    while start < t:
        end = min(start + chunk, t)
        ctx = context if start - context > 0 else start
        spans.append((start, end, ctx))
        start = end
    return spans
