"""25 Hz (V1) codec decoder: flow-matching DiT → mel → BigVGAN → waveform
(PyTorch counterpart of ``qwen_tts_tpu/models/codec_v1.py``).

* **DiT**: an AdaLN-Zero transformer conditioned on the diffusion time. Its
  input joins the noisy mel, an ECAPA summary of the reference mel, the codes'
  embeddings (each repeated ``repeats`` times) and the CAM++ x-vector.
  Attention is block-local (blocks of 24 frames; some layers also see one
  block back or ahead), with RoPE rotating interleaved pairs. Sampling runs
  Euler steps over sway-warped times, with classifier-free guidance (CFG) as
  a doubled batch.
* **BigVGAN**: mel pre-processing (exp → dB → [-1, 1]), a conv stack with
  anti-aliased SnakeBeta (2x kaiser-sinc up- and down-sampling around each
  activation), transposed-conv upsampling and AMP residual blocks.

Layouts: the DiT runs channels-last ``[B, T, D]`` with ``[in, out]`` linears
(``x @ w``); BigVGAN runs channels-first ``[B, C, T]`` with PyTorch's conv
weights (``[C_out, C_in, K]``, transposed convs ``[C_in, C_out, K]``), as the
checkpoint stores them. Activations follow the parameter dtype; the Euler
state and the DiT's output are f32. f32 parameters compute in full f32 on the
card (``utils.full_f32``).

Every option the JAX package names is here: ``attn_impl`` ("local_hs", the
default, "local", "local_hs_bo", "chunked", "chunked_hs") and ``aa_impl``
("conv", the default, "poly", "polyc") compute the same function. A name
outside those raises ``ValueError``.

The initial noise of the Euler state comes from ``initial_noise`` (a
``torch.randn`` on a generator) unless the caller passes ``noise=``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import BigVGANConfig, CodecV1Config, DiTConfig
from qwen_tts_tpu_torch.models.speaker import init_speaker_params, speaker_encoder_forward
from qwen_tts_tpu_torch.ops.convs import causal_conv1d_cf
from qwen_tts_tpu_torch.ops.snake import snake_beta
from qwen_tts_tpu_torch.utils import full_f32, normal_init

NEG_INF = -1e9
ATTN_IMPLS = ("local_hs", "local", "local_hs_bo", "chunked", "chunked_hs")
AA_IMPLS = ("conv", "poly", "polyc")
_HALFSPLIT = ("local_hs", "local_hs_bo", "chunked_hs")


def _check_impl(name: str, value: str, allowed: Sequence[str]) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {name} {value!r}; expected one of {', '.join(allowed)}")


# --------------------------------------------------------------------------
# DiT pieces
# --------------------------------------------------------------------------

def _rope_angles(seq_len: int, head_dim: int, theta: float) -> np.ndarray:
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return np.arange(seq_len)[:, None] * inv_freq[None, :]


def _tables(t: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(np.cos(t), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(t), dtype=torch.float32, device=device))


def _interleaved_rope_tables(seq_len: int, head_dim: int, theta: float, device=None):
    """cos/sin [T, head_dim] with interleaved duplication:
    table[t, 2i] = table[t, 2i+1] = f(t * theta^(-2i/d))."""
    t = _rope_angles(seq_len, head_dim, theta)
    return _tables(np.stack([t, t], axis=-1).reshape(seq_len, head_dim), device)


def _halfsplit_rope_tables(seq_len: int, head_dim: int, theta: float, device=None):
    """cos/sin [T, head_dim] with half-split duplication:
    table[t, i] = table[t, half + i] = f(t * theta^(-2i/d))."""
    t = _rope_angles(seq_len, head_dim, theta)
    return _tables(np.concatenate([t, t], axis=-1), device)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) → (-x1, x0, -x3, x2, ...)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def _apply_rope_interleaved(x, cos, sin):
    return (x * cos + _rotate_pairs(x) * sin).to(x.dtype)


def _apply_rope_halfsplit(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rot * sin).to(x.dtype)


def _rope_halfsplit_layer(layer: dict, heads: int, head_dim: int) -> dict:
    """Permute wq/wk output channels per head: (0, 1, 2, ...) → (evens |
    odds). q'·k' == q·k for any permutation the two share, so attention is
    unchanged, and the pair rotation becomes the half-split one."""
    perm = np.arange(head_dim).reshape(-1, 2).T.reshape(-1)
    full = torch.as_tensor((np.arange(heads)[:, None] * head_dim + perm[None, :]).reshape(-1),
                           device=layer["wq"].device)
    out = dict(layer)
    out["wq"] = layer["wq"][:, full]
    out["bq"] = layer["bq"][full]
    out["wk"] = layer["wk"][:, full]
    out["bk"] = layer["bk"][full]
    return out


def _sinus_time_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """t: [B] → [B, dim] (f32)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    arg = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def _ln_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _block_mask(seq_len: int, block_size: int, look_back: int, look_ahead: int,
                device=None) -> torch.Tensor:
    """[T, T] bool, True = attend."""
    blocks = np.arange(seq_len) // block_size
    diff = blocks[None, :] - blocks[:, None]
    return torch.as_tensor((diff >= -look_back) & (diff <= look_ahead), device=device)


def _qkv(layer: dict, x: torch.Tensor, heads: int, head_dim: int):
    b, t, _ = x.shape
    return tuple((x @ layer["w" + n] + layer["b" + n]).view(b, t, heads, head_dim)
                 for n in "qkv")


def _scores(spec: str, q: torch.Tensor, k: torch.Tensor, head_dim: int) -> torch.Tensor:
    """f32 scores q·k / sqrt(head_dim), whatever the activations' dtype."""
    return torch.einsum(spec, q.float(), k.float()) / math.sqrt(head_dim)


def _dit_attention(layer: dict, x: torch.Tensor, cos, sin, mask, heads: int, head_dim: int):
    """Dense masked attention with interleaved rope (the oracle of the
    block-local forms). ``mask``: [T, T] bool."""
    b, t, _ = x.shape
    q, k, v = _qkv(layer, x, heads, head_dim)
    q = _apply_rope_interleaved(q, cos[None, :, None], sin[None, :, None])
    k = _apply_rope_interleaved(k, cos[None, :, None], sin[None, :, None])
    scores = _scores("bihd,bjhd->bhij", q, k, head_dim).masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bjhd->bihd", probs, v).to(x.dtype)
    return out.reshape(b, t, -1) @ layer["wo"] + layer["bo"]


def _pad_blocks(a: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Pad axis 1 of [B, N, rows, H, hd] with zero blocks."""
    return F.pad(a, (0, 0, 0, 0, 0, 0, before, after))


def _dit_attention_local(layer: dict, x: torch.Tensor, cos, sin, look_back: int,
                         look_ahead: int, block: int, heads: int, head_dim: int,
                         halfsplit: bool = False, batch_order: bool = False):
    """Block-local attention computed block by block: query block n attends
    keys in blocks [n - look_back, n + look_ahead], keys past the end masked
    to -1e9. Scores are [B, H, nb, block, w] instead of [B, H, T, T]."""
    b, t, _ = x.shape
    nb = -(-t // block)
    t_pad = nb * block
    n_win = look_back + 1 + look_ahead
    w = n_win * block

    q, k, v = _qkv(layer, x, heads, head_dim)
    rope = _apply_rope_halfsplit if halfsplit else _apply_rope_interleaved
    q = rope(q, cos[None, :, None], sin[None, :, None])
    k = rope(k, cos[None, :, None], sin[None, :, None])

    def blocks(a):  # [B, T, H, hd] → [B, nb, block, H, hd]
        return F.pad(a, (0, 0, 0, 0, 0, t_pad - t)).view(b, nb, block, heads, head_dim)

    def neighbors(a):  # [B, nb, block, H, hd] → [B, nb, w, H, hd]
        ap = _pad_blocks(a, look_back, look_ahead)
        return torch.cat([ap[:, i : i + nb] for i in range(n_win)], dim=2)

    qb = blocks(q)
    kn, vn = neighbors(blocks(k)), neighbors(blocks(v))

    off = torch.arange(w, device=x.device)[None, :]
    blk = torch.arange(nb, device=x.device)[:, None]
    key_block = blk + off // block - look_back
    key_pos = key_block * block + off % block
    valid = (key_block >= 0) & (key_block < nb) & (key_pos < t)  # [nb, w]
    if batch_order:  # score batch axes in the input's order (b, n, h)
        scores = _scores("bnqhd,bnkhd->bnhqk", qb, kn, head_dim)
        scores = scores.masked_fill(~valid[None, :, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vn.dtype)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, vn)
    else:
        scores = _scores("bnqhd,bnkhd->bhnqk", qb, kn, head_dim)
        scores = scores.masked_fill(~valid[None, None, :, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vn.dtype)
        out = torch.einsum("bhnqk,bnkhd->bnqhd", probs, vn)
    out = out.to(x.dtype).reshape(b, t_pad, heads * head_dim)[:, :t]
    return out @ layer["wo"] + layer["bo"]


def _dit_attention_chunked(layer: dict, x: torch.Tensor, cos, sin, look_back: int,
                           look_ahead: int, block: int, heads: int, head_dim: int,
                           chunk_blocks: int = 5, halfsplit: bool = False):
    """Block-local attention with queries tiled in chunks of
    ``chunk_blocks`` blocks; the superset scores are masked back to each
    block's exact window, so the result is the block-local one."""
    b, t, _ = x.shape
    nb = -(-t // block)
    g = chunk_blocks
    nc = -(-nb // g)
    t_pad = nc * g * block
    p = g + look_back + look_ahead
    w = p * block
    qlen = g * block

    q, k, v = _qkv(layer, x, heads, head_dim)
    rope = _apply_rope_halfsplit if halfsplit else _apply_rope_interleaved
    q = rope(q, cos[None, :, None], sin[None, :, None])
    k = rope(k, cos[None, :, None], sin[None, :, None])

    def pad_t(a):
        return F.pad(a, (0, 0, 0, 0, 0, t_pad - t))

    qc = pad_t(q).view(b, nc, qlen, heads, head_dim)
    if look_back == 0 and look_ahead == 0:
        kw = pad_t(k).view(b, nc, w, heads, head_dim)
        vw = pad_t(v).view(b, nc, w, heads, head_dim)
    else:
        def windows(a):  # [B, nc*g, block, H, hd] → [B, nc, p*block, H, hd]
            ap = _pad_blocks(pad_t(a).view(b, nc * g, block, heads, head_dim),
                             look_back, look_ahead)
            return torch.cat([ap[:, j : j + (nc - 1) * g + 1 : g] for j in range(p)], dim=2)

        kw, vw = windows(k), windows(v)

    scores = _scores("bnqhd,bnkhd->bhnqk", qc, kw, head_dim)
    dev = x.device
    qq = torch.arange(qlen, device=dev)[None, :, None]
    kk = torch.arange(w, device=dev)[None, None, :]
    cc = torch.arange(nc, device=dev)[:, None, None]
    q_block = cc * g + qq // block
    k_block = cc * g - look_back + kk // block
    k_pos = k_block * block + kk % block
    diff = k_block - q_block
    valid = ((k_block >= 0) & (k_block < nb) & (k_pos < t)
             & (diff >= -look_back) & (diff <= look_ahead))  # [nc, qlen, w]
    scores = scores.masked_fill(~valid[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vw.dtype)
    out = torch.einsum("bhnqk,bnkhd->bnqhd", probs, vw).to(x.dtype)
    out = out.reshape(b, t_pad, heads * head_dim)[:, :t]
    return out @ layer["wo"] + layer["bo"]


def _dit_layer(layer: dict, x: torch.Tensor, time_emb: torch.Tensor, cos, sin,
               window: Tuple[int, int], cfg: DiTConfig, attn_impl: str = "local_hs"):
    """One transformer block. ``window``: (look_back, look_ahead) in blocks."""
    _check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    mod = F.silu(time_emb) @ layer["ada_w"] + layer["ada_b"]
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    normed = _ln_noaffine(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    look_back, look_ahead = window
    if attn_impl.startswith("local"):
        attn = _dit_attention_local(
            layer, normed, cos, sin, look_back, look_ahead, cfg.block_size,
            cfg.num_attention_heads, cfg.head_dim, halfsplit=attn_impl in _HALFSPLIT,
            batch_order=attn_impl == "local_hs_bo")
    else:
        attn = _dit_attention_chunked(
            layer, normed, cos, sin, look_back, look_ahead, cfg.block_size,
            cfg.num_attention_heads, cfg.head_dim, halfsplit=attn_impl in _HALFSPLIT)
    x = x + gate_msa[:, None] * attn
    normed = _ln_noaffine(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    h = F.gelu(normed @ layer["ff1_w"] + layer["ff1_b"], approximate="tanh")
    h = h @ layer["ff2_w"] + layer["ff2_b"]
    return x + gate_mlp[:, None] * h


def dit_prepare(params: dict, cfg: DiTConfig, seq_len: int, attn_impl: str = "local_hs"):
    """(layers, cos, sin) of ``attn_impl`` at ``seq_len`` frames: the
    half-split forms take the permuted q/k weights and half-split tables, the
    others the checkpoint's weights and interleaved tables. ``dit_sample``
    prepares once for all its steps."""
    _check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    device = params["in_proj_w"].device
    if attn_impl in _HALFSPLIT:
        cos, sin = _halfsplit_rope_tables(seq_len, cfg.head_dim, cfg.rope_theta, device)
        layers = [_rope_halfsplit_layer(l, cfg.num_attention_heads, cfg.head_dim)
                  for l in params["layers"]]
    else:
        cos, sin = _interleaved_rope_tables(seq_len, cfg.head_dim, cfg.rope_theta, device)
        layers = params["layers"]
    return layers, cos, sin


def dit_forward(
    params: dict,
    cfg: DiTConfig,
    noisy_mel: torch.Tensor,    # [B, T, mel] (CFG-doubled if doubled)
    spk_summary: torch.Tensor,  # [B, T, enc_dim]: ECAPA(ref_mel), repeated
    code_embed: torch.Tensor,   # [B, T, emb_dim]
    xvec: torch.Tensor,         # [B, T, enc_emb_dim]
    t_step: torch.Tensor,       # [B] diffusion time
    attn_impl: str = "local_hs",
    prepared=None,
) -> torch.Tensor:
    """One velocity evaluation, [B, T, mel] f32. Activations follow the
    parameter dtype. ``prepared``: ``dit_prepare``'s result for this length
    and ``attn_impl`` (made here if None)."""
    dt = params["in_proj_w"].dtype
    if prepared is None:
        prepared = dit_prepare(params, cfg, noisy_mel.shape[1], attn_impl)
    layers, cos, sin = prepared
    time_emb = _sinus_time_embedding(t_step, 256).to(dt)
    time_emb = F.silu(time_emb @ params["time_w1"] + params["time_b1"])
    time_emb = time_emb @ params["time_w2"] + params["time_b2"]

    x = torch.cat([noisy_mel.to(dt), spk_summary.to(dt), code_embed.to(dt), xvec.to(dt)],
                  dim=-1)
    x = x @ params["in_proj_w"] + params["in_proj_b"]
    for i, layer in enumerate(layers):
        window = (int(i in cfg.look_backward_layers), int(i in cfg.look_ahead_layers))
        x = _dit_layer(layer, x, time_emb, cos, sin, window, cfg, attn_impl)

    mod = F.silu(time_emb) @ params["out_ada_w"] + params["out_ada_b"]
    scale, shift = mod.chunk(2, dim=-1)
    x = _ln_noaffine(x) * (1 + scale[:, None]) + shift[:, None]
    return (x @ params["out_proj_w"] + params["out_proj_b"]).float()


def initial_noise(batch: int, t_mel: int, mel_dim: int,
                  generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The Euler state's starting point [B, T_mel, mel] f32, drawn with
    ``torch.randn`` on ``generator`` (on the generator's device). The CPU
    tests draw the same tensor and hand it to the JAX package's ``noise=``."""
    if generator is not None:
        device = generator.device
    return torch.randn((batch, t_mel, mel_dim), generator=generator, device=device,
                       dtype=torch.float32)


def euler_times(num_steps: int, sway_coefficient: Optional[float]) -> torch.Tensor:
    """The sway-warped ``linspace(0, 1, num_steps)`` (f32, on the CPU)."""
    t = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    if sway_coefficient is not None:
        t = t + sway_coefficient * (torch.cos(math.pi / 2 * t) - 1 + t)
    return t


def dit_sample(
    params: dict,
    cfg: DiTConfig,
    codes: torch.Tensor,    # [B, T_code] int, >= 0
    ref_mel: torch.Tensor,  # [B, T_ref, mel]
    xvector: torch.Tensor,  # [B, enc_emb_dim]
    generator: Optional[torch.Generator] = None,
    *,
    num_steps: int = 10,
    guidance_scale: float = 0.5,
    sway_coefficient: Optional[float] = -1.0,
    noise: Optional[torch.Tensor] = None,
    attn_impl: str = "local_hs",
) -> torch.Tensor:
    """Euler sampling with CFG. Returns the mel [B, T_code * repeats, mel]
    (f32). ``noise`` overrides the initial state (its first T_mel frames);
    otherwise ``initial_noise`` draws it from ``generator``. The
    unconditional half of the CFG batch takes ECAPA of a zero mel, zero
    x-vectors and the embedding of code 0; below ``guidance_scale`` 1e-5
    there is no CFG."""
    device = params["in_proj_w"].device
    b, t_code = codes.shape
    t_mel = t_code * cfg.repeats
    if noise is None:
        x = initial_noise(b, t_mel, cfg.mel_dim, generator, device)
    else:
        x = torch.as_tensor(noise, dtype=torch.float32, device=device)[:, :t_mel]
    ref_mel = torch.as_tensor(ref_mel, dtype=torch.float32, device=device)
    xvector = torch.as_tensor(xvector, dtype=torch.float32, device=device)

    spk_cfg = cfg.spk_encoder_config()
    spk = speaker_encoder_forward(params["spk_encoder"], spk_cfg, ref_mel)
    spk_rep = spk[:, None].expand(b, t_mel, cfg.enc_dim)
    xvec_rep = xvector[:, None].expand(b, t_mel, cfg.enc_emb_dim)
    table = params["codec_embed"]
    code_emb = table[codes].repeat_interleave(cfg.repeats, dim=1)

    apply_cfg = guidance_scale >= 1e-5
    if apply_cfg:
        spk_zero = speaker_encoder_forward(params["spk_encoder"], spk_cfg,
                                           torch.zeros_like(ref_mel))
        spk_in = torch.cat([spk_rep, spk_zero[:, None].expand(b, t_mel, cfg.enc_dim)])
        xv_in = torch.cat([xvec_rep, torch.zeros_like(xvec_rep)])
        uncond = table[torch.zeros_like(codes)].repeat_interleave(cfg.repeats, dim=1)
        ce_in = torch.cat([code_emb, uncond])
    else:
        spk_in, xv_in, ce_in = spk_rep, xvec_rep, code_emb

    prepared = dit_prepare(params, cfg, t_mel, attn_impl)
    times = euler_times(num_steps, sway_coefficient).to(device)
    bsz = ce_in.shape[0]
    for i in range(num_steps - 1):
        t0, t1 = times[i], times[i + 1]
        pred = dit_forward(params, cfg, torch.cat([x, x]) if apply_cfg else x, spk_in,
                           ce_in, xv_in, t0.expand(bsz), attn_impl, prepared)
        if apply_cfg:
            cond, uncond_pred = pred.chunk(2)
            pred = cond + (cond - uncond_pred) * guidance_scale
        x = x + pred * (t1 - t0)
    return x


# --------------------------------------------------------------------------
# BigVGAN (channels-first [B, C, T])
# --------------------------------------------------------------------------

def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass filter [kernel_size] (float32)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    attenuation = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21.0:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time_idx = np.arange(-half_size, half_size) + 0.5
    else:
        time_idx = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((kernel_size,), np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time_idx)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def make_aa_filters() -> dict:
    """The shared 2x anti-aliasing filters (kernel 12, the BigVGAN
    defaults), numpy float32."""
    return {"up": kaiser_sinc_filter1d(0.25, 0.3, 12),
            "down": kaiser_sinc_filter1d(0.25, 0.3, 12)}


def _replicate_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(x, (left, right), mode="replicate")


def _shared_filter(filt: torch.Tensor, channels: int, dtype) -> torch.Tensor:
    """One filter [K] for every channel: a grouped conv's [C, 1, K] weight."""
    return filt.to(dtype).view(1, 1, -1).expand(channels, 1, -1).contiguous()


def _depthwise_conv(x: torch.Tensor, filt: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: [B, C, T]; ``filt`` [K] shared across channels."""
    c = x.shape[1]
    return F.conv1d(x, _shared_filter(filt, c, x.dtype), stride=stride, groups=c)


def _depthwise_conv_transpose(x: torch.Tensor, filt: torch.Tensor, stride: int) -> torch.Tensor:
    """The full transposed conv (length (T-1)*stride + K) with ``filt``
    shared across channels."""
    c = x.shape[1]
    return F.conv_transpose1d(x, _shared_filter(filt, c, x.dtype), stride=stride, groups=c)


def _snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta over channels-first ``x`` (per-channel ``alpha``/``beta``
    [C] as [C, 1])."""
    return snake_beta(x, alpha[:, None], beta[:, None])


def _anti_aliased_snake_conv(x: torch.Tensor, alpha, beta, up_filt, down_filt,
                             ratio: int = 2) -> torch.Tensor:
    """The direct form: ``ratio``x upsample (zero-stuffed transposed conv),
    SnakeBeta at the high rate, low-pass and decimate."""
    k_up = up_filt.shape[0]
    pad = k_up // ratio - 1
    pad_left = pad * ratio + (k_up - ratio) // 2
    pad_right = pad * ratio + (k_up - ratio + 1) // 2
    h = ratio * _depthwise_conv_transpose(_replicate_pad(x, pad, pad), up_filt, ratio)
    h = _snake(h[..., pad_left : h.shape[-1] - pad_right], alpha, beta)
    k_dn = down_filt.shape[0]
    even = k_dn % 2 == 0
    h = _replicate_pad(h, k_dn // 2 - int(even), k_dn // 2)
    return _depthwise_conv(h, down_filt, stride=ratio)


def _edges(s0: torch.Tensor, s1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two output phases with the 2x-rate edges replicated (left edge
    s0[0], right edge s1[T-1])."""
    t = s0.shape[-1]
    left, right = s0[..., :1], s1[..., t - 1 : t]
    return (torch.cat([left, left, s0, right, right, right], dim=-1),
            torch.cat([left, left, left, s1, right, right], dim=-1))


def _aa_snake_poly(x: torch.Tensor, alpha, beta, up_filt, down_filt) -> torch.Tensor:
    """Phase-split form of the direct one for ratio 2 and 12 taps: each
    output phase of the upsampler is a 6-tap sum at the input rate,
    SnakeBeta applies per phase, and the decimating filter reads the phases
    directly."""
    t = x.shape[-1]
    xe = _replicate_pad(x, 3, 3).float()
    p0 = up_filt[1].float() * xe[..., 5 : 5 + t]
    p1 = up_filt[0].float() * xe[..., 6 : 6 + t]
    for i in range(1, 6):
        p0 = p0 + up_filt[2 * i + 1].float() * xe[..., 5 - i : 5 - i + t]
        p1 = p1 + up_filt[2 * i].float() * xe[..., 6 - i : 6 - i + t]
    s0e, s1e = _edges(_snake((2.0 * p0).to(x.dtype), alpha, beta),
                      _snake((2.0 * p1).to(x.dtype), alpha, beta))
    s0e, s1e = s0e.float(), s1e.float()
    y = down_filt[1].float() * s0e[..., :t]
    y = y + down_filt[0].float() * s1e[..., :t]
    for i in range(1, 6):
        y = y + down_filt[2 * i + 1].float() * s0e[..., i : i + t]
        y = y + down_filt[2 * i].float() * s1e[..., i : i + t]
    return y.to(x.dtype)


def _aa_snake_polyc(x: torch.Tensor, alpha, beta, up_filt, down_filt) -> torch.Tensor:
    """The phase-split form with each phase's taps as a 6-tap depthwise
    conv."""
    t = x.shape[-1]
    xe = _replicate_pad(x, 3, 3)
    dev = up_filt.device
    k0 = 2.0 * up_filt[torch.arange(11, -1, -2, device=dev)]
    k1 = 2.0 * up_filt[torch.arange(10, -2, -2, device=dev)]
    s0e, s1e = _edges(_snake(_depthwise_conv(xe[..., : t + 5], k0), alpha, beta),
                      _snake(_depthwise_conv(xe[..., 1 : t + 6], k1), alpha, beta))
    g0 = down_filt[torch.arange(1, 12, 2, device=dev)]
    g1 = down_filt[torch.arange(0, 11, 2, device=dev)]
    return _depthwise_conv(s0e, g0) + _depthwise_conv(s1e, g1)


def _anti_aliased_snake(x: torch.Tensor, alpha, beta, up_filt, down_filt, ratio: int = 2,
                        aa_impl: str = "conv") -> torch.Tensor:
    """2x upsample → SnakeBeta → 2x downsample. The phase-split forms apply
    at ratio 2 with 12-tap filters; elsewhere every form is the direct one."""
    _check_impl("aa_impl", aa_impl, AA_IMPLS)
    if ratio == 2 and up_filt.shape[0] == 12 and down_filt.shape[0] == 12:
        if aa_impl == "poly":
            return _aa_snake_poly(x, alpha, beta, up_filt, down_filt)
        if aa_impl == "polyc":
            return _aa_snake_polyc(x, alpha, beta, up_filt, down_filt)
    return _anti_aliased_snake_conv(x, alpha, beta, up_filt, down_filt, ratio)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 dilation: int = 1) -> torch.Tensor:
    """Non-causal conv padded (k*d - d)//2 on each side. w: [C_out, C_in, K]."""
    pad = (w.shape[-1] * dilation - dilation) // 2
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), padding=pad,
                    dilation=dilation)


def _conv_transpose_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                         stride: int) -> torch.Tensor:
    """ConvTranspose1d(k, s, padding=(k-s)//2): the full transposed conv
    with (k-s)//2 samples cut from each side. w: [C_in, C_out, K]."""
    return F.conv_transpose1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                              stride=stride, padding=(w.shape[-1] - stride) // 2)


def _amp_block(p: dict, x: torch.Tensor, dilations: Sequence[int], causal_type: str,
               filters: dict, aa_impl: str = "conv") -> torch.Tensor:
    """AMP residual block. Type "2" (the first two stages) starts with a
    conv and an activation and keeps both convs of each pair causal; type
    "1" makes the second conv of each pair non-causal."""
    up, down = filters["up"], filters["down"]

    def act(a, b, h):
        return _anti_aliased_snake(h, a, b, up, down, aa_impl=aa_impl)

    if causal_type == "2":
        h = act(p["pre_alpha"], p["pre_beta"],
                _conv1d_same(x, p["pre_conv_w"], p["pre_conv_b"]))
    else:
        h = x
    out = x
    for j, dilation in enumerate(dilations):
        h = act(p["act_alpha"][2 * j], p["act_beta"][2 * j], h)
        h = causal_conv1d_cf(h, p["conv1_w"][j], p["conv1_b"][j], dilation=dilation)
        h = act(p["act_alpha"][2 * j + 1], p["act_beta"][2 * j + 1], h)
        if causal_type == "1":
            h = _conv1d_same(h, p["conv2_w"][j], p["conv2_b"][j])
        else:
            h = causal_conv1d_cf(h, p["conv2_w"][j], p["conv2_b"][j])
        out = out + h
    return out


def _process_mel(mel: torch.Tensor) -> torch.Tensor:
    """exp → dB (floor -115) - 20 → normalised to [-1, 1], f32."""
    amplitude = torch.exp(mel.float())
    min_level = torch.exp(torch.tensor(-115 / 20.0 * np.log(10), dtype=torch.float32,
                                       device=mel.device))
    db = 20.0 * torch.log10(torch.maximum(amplitude, min_level)) - 20.0
    return torch.clamp(2.0 * ((db + 115.0) / 115.0) - 1.0, -1.0, 1.0)


def bigvgan_forward(params: dict, cfg: BigVGANConfig, mel: torch.Tensor,
                    aa_impl: str = "conv", clamp: bool = True) -> torch.Tensor:
    """mel [B, T, mel_dim] → waveform [B, T * total_upsample] (f32), clamped
    to [-1, 1] unless ``clamp`` is False. Activations follow the parameter
    dtype."""
    _check_impl("aa_impl", aa_impl, AA_IMPLS)
    filters = params["_filters"]
    h = _process_mel(mel).to(params["pre_w"].dtype).transpose(1, 2)
    h = _conv1d_same(h, params["pre_w"], params["pre_b"])
    n_res = len(cfg.resblock_kernel_sizes)
    for li, rate in enumerate(cfg.upsample_rates):
        h = _conv_transpose_same(h, params["ups_w"][li], params["ups_b"][li], stride=rate)
        acc = None
        for bi in range(n_res):
            r = _amp_block(params["resblocks"][li * n_res + bi], h,
                           cfg.resblock_dilation_sizes[bi], "1" if li > 1 else "2", filters,
                           aa_impl=aa_impl)
            acc = r if acc is None else acc + r
        h = acc / n_res
    h = _anti_aliased_snake(h, params["post_alpha"], params["post_beta"], filters["up"],
                            filters["down"], aa_impl=aa_impl)
    wav = _conv1d_same(h, params["post_w"], None)[:, 0].float()
    return wav.clamp(-1.0, 1.0) if clamp else wav


# --------------------------------------------------------------------------
# Full decode
# --------------------------------------------------------------------------

def check_codes(codes: Union[np.ndarray, torch.Tensor], num_embeds: int) -> None:
    """Raise ``ValueError`` naming the first code id above ``num_embeds``
    (the embedding table's last row); negative ids are padding. A tensor on
    the card is read back once for this."""
    a = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    bad = a > num_embeds
    if bad.any():
        where = tuple(int(i) for i in np.argwhere(bad)[0])
        raise ValueError(f"code {int(a[where])} at {where} is above num_embeds "
                         f"({num_embeds})")


def codec_v1_decode(
    params: dict,
    cfg: CodecV1Config,
    codes,                  # [B, T] int (negative ids are padding: clamped to 0)
    xvectors,               # [B, enc_emb_dim]
    ref_mels,               # [B, T_mel, mel_dim]
    generator: Optional[torch.Generator] = None,
    *,
    num_steps: int = 10,
    guidance_scale: float = 0.5,
    sway_coefficient: float = -1.0,
    noise: Optional[torch.Tensor] = None,
    attn_impl: str = "local_hs",
    aa_impl: str = "conv",
) -> torch.Tensor:
    """Codes → waveform [B, T * repeats * total_upsample] (f32, clamped).
    Runs on the parameters' device; f32 parameters compute without TF32."""
    _check_impl("attn_impl", attn_impl, ATTN_IMPLS)
    _check_impl("aa_impl", aa_impl, AA_IMPLS)
    check_codes(codes, cfg.dit.num_embeds)
    device = params["dit"]["in_proj_w"].device
    codes = torch.as_tensor(codes, device=device).long().clamp(min=0)
    with full_f32():
        mel = dit_sample(params["dit"], cfg.dit, codes, ref_mels, xvectors, generator,
                         num_steps=num_steps, guidance_scale=guidance_scale,
                         sway_coefficient=sway_coefficient, noise=noise,
                         attn_impl=attn_impl)
        return bigvgan_forward(params["bigvgan"], cfg.bigvgan, mel, aa_impl=aa_impl)


# --------------------------------------------------------------------------
# Random init (tests and card runs without a checkpoint)
# --------------------------------------------------------------------------

def _filled(shape, value: float, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def init_dit_params(generator: torch.Generator, cfg: DiTConfig, dtype=torch.float32,
                    device=None) -> dict:
    """Random DiT weights in the loader's layout (linears ``[in, out]``):
    matrices N(0, 1/fan_in), biases zeros; the ECAPA-TDNN from
    ``init_speaker_params`` in float32, as the loader keeps it. The JAX
    package's ``init_dit_params`` keys and shapes."""
    device = device if device is not None else generator.device
    h = cfg.hidden_size
    in_dim = cfg.mel_dim + cfg.enc_dim + cfg.emb_dim + cfg.enc_emb_dim
    qd = cfg.num_attention_heads * cfg.head_dim
    ff = h * cfg.ff_mult

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    def zeros(n):
        return _filled((n,), 0.0, dtype, device)

    layers = [{
        "ada_w": w((h, 6 * h), h), "ada_b": zeros(6 * h),
        "wq": w((h, qd), h), "bq": zeros(qd),
        "wk": w((h, qd), h), "bk": zeros(qd),
        "wv": w((h, qd), h), "bv": zeros(qd),
        "wo": w((qd, h), qd), "bo": zeros(h),
        "ff1_w": w((h, ff), h), "ff1_b": zeros(ff),
        "ff2_w": w((ff, h), ff), "ff2_b": zeros(h),
    } for _ in range(cfg.num_hidden_layers)]
    return {
        "time_w1": w((256, h), 256), "time_b1": zeros(h),
        "time_w2": w((h, h), h), "time_b2": zeros(h),
        "codec_embed": w((cfg.num_embeds + 1, cfg.emb_dim), cfg.emb_dim),
        "in_proj_w": w((in_dim, h), in_dim), "in_proj_b": zeros(h),
        "spk_encoder": init_speaker_params(generator, cfg.spk_encoder_config(), torch.float32,
                                           device),
        "layers": layers,
        "out_ada_w": w((h, 2 * h), h), "out_ada_b": zeros(2 * h),
        "out_proj_w": w((h, cfg.mel_dim), h), "out_proj_b": zeros(cfg.mel_dim),
    }


def init_bigvgan_params(generator: torch.Generator, cfg: BigVGANConfig, dtype=torch.float32,
                        device=None) -> dict:
    """Random BigVGAN weights in the loader's layout (convs ``[C_out, C_in,
    K]``, transposed convs ``[C_in, C_out, K]``): N(0, 1/(C_in K)) weights,
    zero biases, SnakeBeta's pre-exponentiated alpha and beta ones, a
    pre-conv in the blocks of the first two stages only, the anti-aliasing
    filters of ``make_aa_filters`` in float32. The JAX package's
    ``init_bigvgan_params`` keys and shapes."""
    device = device if device is not None else generator.device

    def w(shape, fan_in):
        return normal_init(shape, fan_in, generator, dtype, device)

    def ones(*shape):
        return _filled(shape, 1.0, dtype, device)

    def zeros(*shape):
        return _filled(shape, 0.0, dtype, device)

    c0 = cfg.upsample_initial_channel
    ups_w, ups_b, resblocks = [], [], []
    for li, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = c0 // 2 ** li, c0 // 2 ** (li + 1)
        ups_w.append(w((cin, cout, k), cin * k))
        ups_b.append(zeros(cout))
        for ks, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            n = len(dil)
            blk = {
                "conv1_w": w((n, cout, cout, ks), ks * cout), "conv1_b": zeros(n, cout),
                "conv2_w": w((n, cout, cout, ks), ks * cout), "conv2_b": zeros(n, cout),
                "act_alpha": ones(2 * n, cout), "act_beta": ones(2 * n, cout),
            }
            if li <= 1:  # causal type "2" blocks carry a pre-conv and a pre-activation
                blk.update(pre_conv_w=w((cout, cout, ks), ks * cout), pre_conv_b=zeros(cout),
                           pre_alpha=ones(cout), pre_beta=ones(cout))
            resblocks.append(blk)
    c_last = c0 // 2 ** len(cfg.upsample_rates)
    return {
        "pre_w": w((c0, cfg.mel_dim, 5), 5 * cfg.mel_dim),
        "pre_b": zeros(c0),
        "ups_w": ups_w,
        "ups_b": ups_b,
        "resblocks": resblocks,
        "post_alpha": ones(c_last),
        "post_beta": ones(c_last),
        "post_w": w((1, c_last, 7), 7 * c_last),
        "_filters": {k: torch.as_tensor(v, device=device) for k, v in make_aa_filters().items()},
    }


def init_codec_v1_params(generator: torch.Generator, cfg: CodecV1Config, dtype=torch.float32,
                         device=None) -> dict:
    """Random 25 Hz decoder weights: ``init_dit_params`` and
    ``init_bigvgan_params`` in turn on one generator, in ``load_codec_v1``'s
    tree. On the ``meta`` device nothing is drawn (shapes and dtypes only)."""
    return {"dit": init_dit_params(generator, cfg.dit, dtype, device),
            "bigvgan": init_bigvgan_params(generator, cfg.bigvgan, dtype, device)}
