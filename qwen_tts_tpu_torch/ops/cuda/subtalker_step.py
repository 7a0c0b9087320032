"""One sub-talker micro-step through the whole int8 trunk: the wrapper of the
hand-written CUDA kernel ``csrc/subtalker_step.cu`` and its plain PyTorch
version.

The kernel replaces the TPU kernel
``scripts/exp_pallas_subtalker_step.py::pallas_subtalker_trunk_step``: one
launch per micro-step runs all the layers (RMSNorm, int8 Q/K/V, QK-norm +
RoPE, the K/V row append, GQA attention over positions ``<= pos``, o-proj,
SwiGLU), with the residual held in f32 and every dot taking its f32 scale
after an f32 accumulation. It is bound by bytes: the int8 weights, 78.6 MB at
the flagship dims, once per launch (23.5 us at 3.35 TB/s). The source notes
its design.

``pack_subtalker_weights`` lays the ``quantize_trunk_int8`` tree out once in
the kernel's layout (below) and checks it; the pack is the only copy of the
weights the serving mode keeps until a route that runs the trunk layer by
layer asks for the tree (``SubtalkerPack.trunk``). The KV cache is the
port's ``[L, B, G, KV, hd]`` in the activation dtype. ``subtalker_step``
launches the kernel for CUDA tensors (flagship dims, float32 or bfloat16,
1 <= B <= 32; anything else raises) and takes ``subtalker_step_plain``,
which un-tiles the pack and works at any dims, only for CPU tensors.
``subtalker_step.launches`` counts kernel launches.

Layout. The output columns of each projection are split over NB blocks (128
at the flagship dims, one per SM); a block owns whole columns over the full
K, in groups of NT tiles of 8 columns: Q/K/V 32 columns in 2 groups of 16,
o-proj and down 8 columns, [gate|up] 3 groups of 8 gate columns with the
matching 8 up columns. A block's share of one layer is one contiguous run
``[group][chunk][k-step][tile][lane][4 bytes]``: chunks of at most 16 KB
(down: 2 of 1536 rows), tiles of 16 k x 8 columns in which lane ``4 g + q``
holds column g at k = 2q, 2q+1, 2q+8, 2q+9 (the ``mma.sync`` B fragment).
The scales follow the same column order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The dims the kernel is compiled for: layers, hidden, heads, KV heads,
# head dim, intermediate (the flagship sub-talker).
KERNEL_DIMS = (5, 1024, 16, 8, 128, 3072)
MAX_BATCH = 32
MAX_GROUPS = 64
TIMELINE_SLOTS = 64  # u64 per block of a timed launch (csrc: kTimelineSlots)
CHUNK_BYTES = 16384  # the kernel's ring stage
_SCALES = {"wqkv": "qkv_s", "wo": "wo_s", "wgu": "gu_s", "down": "down_s"}
_NORMS = ("input_norm", "post_attn_norm", "q_norm", "k_norm")
_fns = {}


def _kernel_fn(name: str):
    if not _fns:
        from qwen_tts_tpu_torch.ops.cuda.build import load_library

        lib = load_library("subtalker_step")
        step = lib.qtts_subtalker_step
        step.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        step.restype = ctypes.c_int
        scratch = lib.qtts_subtalker_step_scratch_bytes
        scratch.argtypes = [ctypes.c_int]
        scratch.restype = ctypes.c_longlong
        shape = lib.qtts_subtalker_step_launch_shape
        shape.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
        shape.restype = ctypes.c_int
        bench = lib.qtts_subtalker_barrier_bench
        bench.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        bench.restype = ctypes.c_int
        _fns.update(step=step, scratch=scratch, shape=shape, bench=bench)
    return _fns[name]


# --------------------------------------------------------------------------
# The kernel layout
# --------------------------------------------------------------------------

def _layout(d: int, n_qkv: int, n_q: int, inter: int) -> Tuple[int, Dict[str, tuple]]:
    """(NB, {projection: (K, N, NT, chunks)}) for these dims."""
    for name, k in (("hidden", d), ("heads x head_dim", n_q), ("intermediate", inter)):
        if k % 16:
            raise ValueError(f"the sub-talker pack needs {name} a multiple of 16, got {k}")
    nb = math.gcd(d // 8, n_qkv // 8, inter // 8)
    qkv_nt = 2 if (n_qkv // nb // 8) % 2 == 0 else 1
    shapes = {"wqkv": (d, n_qkv, qkv_nt), "wo": (n_q, d, 1), "wgu": (d, 2 * inter, 2),
              "down": (inter, d, 1)}
    out = {}
    for name, (k, n, nt) in shapes.items():
        chunks = -(-k * nt * 8 // CHUNK_BYTES)
        while (k // 16) % chunks:
            chunks += 1
        out[name] = (k, n, nt, chunks)
    return nb, out


def _columns(name: str, n: int, nb: int, device) -> torch.Tensor:
    """The layout's column order: position -> column of the row-major
    weight. [gate|up] interleaves each block's gate tiles with the matching
    up tiles; the others keep their order."""
    if name != "wgu":
        return torch.arange(n, device=device)
    inter = n // 2
    gate = torch.arange(inter, device=device).view(nb, -1, 1, 8)  # [NB, groups, 1, 8]
    return torch.cat([gate, gate + inter], dim=2).reshape(-1)


def _tile(w: torch.Tensor, cols: torch.Tensor, nb: int, nt: int, chunks: int) -> torch.Tensor:
    """[L, K, N] row-major -> [L, NB, bytes per block] in the kernel layout."""
    n_layers, k, n = w.shape
    t = w[:, :, cols].reshape(n_layers, chunks, k // 16 // chunks, 2, 4, 2, nb,
                              n // (nb * nt * 8), nt, 8)
    # (L, chunk, k-step, v1, q, v0, NB, group, tile, g): k = 2q + v0 + 8 v1
    return t.permute(0, 6, 7, 1, 2, 8, 9, 4, 3, 5).reshape(n_layers, nb, -1).contiguous()


def _untile(t: torch.Tensor, cols: torch.Tensor, k: int, n: int, nt: int,
            chunks: int) -> torch.Tensor:
    """The inverse of ``_tile``: [L, NB, bytes] -> [L, K, N] row-major."""
    n_layers, nb = t.shape[:2]
    w = t.reshape(n_layers, nb, n // (nb * nt * 8), chunks, k // 16 // chunks, nt, 8, 4, 2, 2)
    w = w.permute(0, 3, 4, 8, 7, 9, 1, 2, 5, 6).reshape(n_layers, k, n)
    out = torch.empty_like(w)
    out[:, :, cols] = w
    return out


def _pack_dims(packed: dict) -> Tuple[int, int, int, int, int]:
    """(L, D, n_qkv, n_q, I) from the pack's shapes."""
    n_layers, d = packed["input_norm"].shape
    n_q = packed["wo"].numel() // (n_layers * d)
    return n_layers, d, packed["qkv_s"].shape[1], n_q, packed["gu_s"].shape[1] // 2


class SubtalkerPack(dict):
    """The kernel's operands, as ``pack_subtalker_weights`` made and checked
    them. ``dtype`` and ``device`` are the activations' and the card's;
    ``kernel_refuses`` says why the kernel cannot take the pack (None if it
    can). The launch scratch is kept here, one per batch size: launches on
    one pack run one after another on one stream; so is the untiled trunk
    (``trunk``)."""

    dtype: torch.dtype
    device: torch.device
    kernel_refuses: str | None

    def scratch(self, batch: int) -> torch.Tensor:
        buf = self._scratch.get(batch)
        if buf is None:  # zeroed once: the grid barrier's count starts at 0
            buf = torch.zeros(_kernel_fn("scratch")(batch), dtype=torch.uint8,
                              device=self.device)
            self._scratch[batch] = buf
        return buf

    def plain_rows(self) -> dict:
        """``unpack_subtalker_weights`` of the pack with the int8 weights
        widened to f32 (the values ``subtalker_step_rows`` multiplies), made
        at the first call and kept: the CPU's micro-steps read them at every
        call, where untiling and widening the weights at each call cost more
        than the step (~320 MB at the flagship dims; CPU packs only)."""
        if self._plain_rows is None:
            rows = unpack_subtalker_weights(self)
            for name in ("wqkv", "wo", "wgu", "down"):
                rows[name] = rows[name].float()
            self._plain_rows = rows
        return self._plain_rows

    def trunk(self) -> dict:
        """The ``quantize_trunk_int8`` tree of the unfused trunk, bit for bit
        (a fused tree's weights split again): the same weights untiled, for
        the routes that run the trunk layer by layer. Made at the first call
        and kept here (~80 MB at the flagship dims), so only a model that runs
        such a route holds its weights twice; not while a graph is captured
        (a frame's warm-up run makes it first)."""
        if self._trunk is None:
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("SubtalkerPack.trunk: untile the pack before a capture")
            rows = unpack_subtalker_weights(self)
            _, d, n_qkv, n_q, inter = _pack_dims(self)
            n_kv = (n_qkv - n_q) // 2
            tree = {k: self[k] for k in _NORMS}
            for name, keys, widths in (("wqkv", ("wq", "wk", "wv"), (n_q, n_kv, n_kv)),
                                       ("wo", ("wo",), (d,)), ("wgu", ("gate", "up"),
                                                               (inter, inter)),
                                       ("down", ("down",), (d,))):
                scales = rows[_SCALES[name]].to(torch.bfloat16)[:, None]  # widened from bf16
                for key, w, s in zip(keys, rows[name].split(widths, dim=-1),
                                     scales.split(widths, dim=-1)):
                    tree[key + "_i8"], tree[key + "_s"] = w.contiguous(), s.contiguous()
            self._trunk = tree
        return self._trunk


def pack_subtalker_weights(trunk: dict) -> SubtalkerPack:
    """The kernel's operands from a ``quantize_trunk_int8`` trunk tree, with
    separate or fused (``wqkv_i8`` / ``wgu_i8``) projections: the int8
    weights of Q/K/V, o-proj, [gate|up] and down tiled into the kernel layout
    (values unchanged: the scales are per output column), the bf16 scales
    widened to f32 in the same column order, the norms as they are. A fused
    tree gives the bytes of its unfused one: the pack joins q|k|v and gate|up
    in the same order. Checked here once, so a launch checks only its
    activations."""
    scale_keys = {"wqkv": ("wq", "wk", "wv"), "wo": ("wo",), "wgu": ("gate", "up"),
                  "down": ("down",)}
    for fused in ("wqkv", "wgu"):
        if fused + "_i8" in trunk and scale_keys[fused][0] + "_i8" not in trunk:
            scale_keys[fused] = (fused,)
    rows = {name: torch.cat([trunk[k + "_i8"] for k in keys], dim=-1)
            for name, keys in scale_keys.items()}
    n_layers, d, n_qkv = rows["wqkv"].shape
    nb, layout = _layout(d, n_qkv, rows["wo"].shape[1], rows["wgu"].shape[-1] // 2)
    pack = SubtalkerPack({k: trunk[k].contiguous() for k in _NORMS})
    for name, (k, n, nt, chunks) in layout.items():
        w = rows[name]
        if w.dtype != torch.int8:
            raise TypeError(f"pack_subtalker_weights: {name} must be int8, got {w.dtype}")
        cols = _columns(name, n, nb, w.device)
        pack[name] = _tile(w, cols, nb, nt, chunks)
        s = torch.cat([trunk[key + "_s"] for key in scale_keys[name]], dim=-1)
        pack[_SCALES[name]] = s.float().reshape(n_layers, n)[:, cols].contiguous()
    _check_pack(pack)
    return pack


def unpack_subtalker_weights(packed: dict) -> dict:
    """The pack's weights and scales row-major again: ``wqkv`` [L, D,
    n_qkv], ``wo`` [L, n_q, D], ``wgu`` [L, D, 2I] (gate | up), ``down``
    [L, I, D] in int8, each scale [L, N] in f32; the norms as they are."""
    n_layers, d, n_qkv, n_q, inter = _pack_dims(packed)
    nb, layout = _layout(d, n_qkv, n_q, inter)
    out = {k: packed[k] for k in _NORMS}
    for name, (k, n, nt, chunks) in layout.items():
        cols = _columns(name, n, nb, packed[name].device)
        out[name] = _untile(packed[name], cols, k, n, nt, chunks)
        s = packed[_SCALES[name]]
        out[_SCALES[name]] = torch.empty_like(s)
        out[_SCALES[name]][:, cols] = s
    return out


def _check_pack(pack: SubtalkerPack) -> None:
    """Set the pack's dtype and device, and whether the kernel takes it."""
    dtype = pack["input_norm"].dtype
    n_layers, d, n_qkv, n_q, inter = _pack_dims(pack)
    hd = pack["q_norm"].shape[1]
    pack.dtype, pack.device, pack._scratch, pack._trunk = dtype, pack["wqkv"].device, {}, None
    pack._plain_rows = None
    for name in _NORMS:
        if pack[name].dtype != dtype:
            raise TypeError(f"pack_subtalker_weights: {name} is {pack[name].dtype}, "
                            f"input_norm {dtype}")
    dims = (n_layers, d, n_q // hd, (n_qkv - n_q) // (2 * hd), hd, inter)
    reasons = []
    if dtype not in _DTYPES:
        reasons.append(f"activations must be float32 or bfloat16, got {dtype}")
    if dims != KERNEL_DIMS:
        reasons.append(f"built for (L, D, H, KV, hd, I) = {KERNEL_DIMS}, got {dims}")
    if any(t.device != pack.device for t in pack.values()):
        reasons.append("operands on more than one device")
    if pack.device.type != "cuda":
        reasons.append(f"operands on {pack.device}")
    pack.kernel_refuses = "; ".join(reasons) or None
    pack._ptrs = tuple(pack[k].data_ptr() for k in (
        "wqkv", "qkv_s", "wo", "wo_s", "wgu", "gu_s", "down", "down_s", *_NORMS))


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _rms(h: torch.Tensor, w: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm of the f32 residual as the kernel rounds it: normed -> dtype,
    times the weight in dtype."""
    normed = (h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)).to(dtype)
    return w.to(dtype) * normed


def _head_norm_rope(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Per-head RMSNorm (normed -> dtype, x weight -> dtype) then RoPE in f32."""
    n = _rms(x, w, eps, dtype).float()
    half = n.shape[-1] // 2
    return n * cos + torch.cat([-n[..., half:], n[..., :half]], dim=-1) * sin


def subtalker_step_rows(
    rows: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch on row-major weights
    (``unpack_subtalker_weights``), at any dims: products of dtype values
    accumulate in f32 and take the f32 scale after the dot; the residual
    stays f32 and is cast once at the end. Writes row ``pos`` of the caches
    in place; returns (hidden [B, D] in x's dtype, k_cache, v_cache)."""
    dtype = x.dtype
    n_layers = rows["wqkv"].shape[0]
    kv, hd = k_cache.shape[3], k_cache.shape[4]
    n_q = rows["wo"].shape[1]
    heads, inter = n_q // hd, rows["down"].shape[1]
    b = x.shape[0]
    cos, sin = cos.float(), sin.float()
    h = x.float()
    for l in range(n_layers):
        xn = _rms(h, rows["input_norm"][l], eps, dtype).float()
        qkv = (xn @ rows["wqkv"][l].float()) * rows["qkv_s"][l]
        q = qkv[:, :n_q].view(b, heads, hd)
        k = qkv[:, n_q:n_q + kv * hd].view(b, kv, hd)
        v = qkv[:, n_q + kv * hd:].view(b, kv, hd)
        k_cache[l, :, pos] = _head_norm_rope(k, rows["k_norm"][l], cos, sin, eps, dtype).to(dtype)
        v_cache[l, :, pos] = v.to(dtype)
        q = _head_norm_rope(q, rows["q_norm"][l], cos, sin, eps, dtype).to(dtype)

        keys = k_cache[l, :, : pos + 1].float()    # [B, P, KV, hd]
        values = v_cache[l, :, : pos + 1].float()
        qg = q.float().view(b, kv, heads // kv, hd)
        scores = torch.einsum("bkgd,bjkd->bkgj", qg, keys) * hd ** -0.5
        probs = torch.softmax(scores, dim=-1).to(dtype).float()
        attn = torch.einsum("bkgj,bjkd->bkgd", probs, values).reshape(b, n_q).to(dtype)
        h = h + (attn.float() @ rows["wo"][l].float()) * rows["wo_s"][l]

        xn = _rms(h, rows["post_attn_norm"][l], eps, dtype).float()
        gu = (xn @ rows["wgu"][l].float()) * rows["gu_s"][l]
        act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(dtype).float()
        h = h + (act @ rows["down"][l].float()) * rows["down_s"][l]
    return h.to(dtype), k_cache, v_cache


def subtalker_step_plain(
    packed: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch on the pack: un-tiles it, then
    ``subtalker_step_rows``."""
    return subtalker_step_rows(unpack_subtalker_weights(packed), x, cos, sin, k_cache, v_cache,
                               pos, eps)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

def _check_call(packed: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                timeline: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take; the pack was checked when it
    was made."""
    if not isinstance(packed, SubtalkerPack):
        raise ValueError("subtalker_step takes the weights as pack_subtalker_weights made them")
    if x.dtype not in _DTYPES:
        raise TypeError(f"subtalker_step takes float32 or bfloat16, got {x.dtype}")
    if packed.kernel_refuses:
        raise ValueError(f"subtalker_step: {packed.kernel_refuses}")
    if x.dtype != packed.dtype:
        raise TypeError(f"subtalker_step: x is {x.dtype}, the pack's norms {packed.dtype}")
    n_layers, d, _, kv, hd, _ = KERNEL_DIMS
    b = x.shape[0]
    if x.shape != (b, d) or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"x must be [B, {d}] with 1 <= B <= {MAX_BATCH}, got {tuple(x.shape)}")
    groups = k_cache.shape[2] if k_cache.dim() == 5 else 0
    if not 1 <= groups <= MAX_GROUPS or not 0 <= pos < groups:
        raise ValueError(f"need 0 <= pos < G <= {MAX_GROUPS}, got pos {pos}, G {groups}")
    for name, t, shape, dtype in (
            ("x", x, (b, d), x.dtype), ("cos", cos, (hd,), torch.float32),
            ("sin", sin, (hd,), torch.float32),
            ("k_cache", k_cache, (n_layers, b, groups, kv, hd), x.dtype),
            ("v_cache", v_cache, (n_layers, b, groups, kv, hd), x.dtype)):
        if t.dtype != dtype:
            raise TypeError(f"subtalker_step: {name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"subtalker_step: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != packed.device or not t.is_contiguous():
            raise ValueError(f"subtalker_step: {name} must be contiguous on {packed.device}")
    if timeline is not None and (timeline.shape != (packed["wqkv"].shape[1], TIMELINE_SLOTS)
                                 or timeline.dtype != torch.int64
                                 or timeline.device != packed.device
                                 or not timeline.is_contiguous()):
        raise ValueError(f"subtalker_step: timeline must be int64 [grid, {TIMELINE_SLOTS}] "
                         f"on {packed.device}")


def launch_shape(dtype: torch.dtype, batch: int) -> Tuple[int, int, int]:
    """(grid blocks, threads per block, dynamic shared bytes) of the
    cooperative launch for ``batch`` rows on the current card."""
    grid, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _kernel_fn("shape")(_DTYPES[dtype], batch, ctypes.byref(grid),
                              ctypes.byref(threads), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"subtalker_step launch shape failed: cudaError {err}")
    return grid.value, threads.value, smem.value


def barrier_bench(n: int, scratch: torch.Tensor) -> None:
    """``n`` of the kernel's grid barriers in one cooperative launch of its
    grid, on the current stream (``scratch``: a pack's scratch, whose barrier
    words it uses). For timing the barrier; not counted as a launch."""
    scratch[64:72].zero_()  # the bench's arrival count
    err = _kernel_fn("bench")(n, scratch.data_ptr(),
                              torch.cuda.current_stream(scratch.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subtalker barrier bench launch failed: cudaError {err}")


def subtalker_step(
    packed: dict,          # pack_subtalker_weights(quantize_trunk_int8(trunk))
    x: torch.Tensor,       # [B, D] micro-step input
    cos: torch.Tensor,     # [hd] f32 RoPE table at pos
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, G, KV, hd], row pos written in place
    v_cache: torch.Tensor,
    pos: int,              # micro-step position, shared by every row
    eps: float,
    timeline: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One micro-step through every layer of the int8 trunk. Returns
    (hidden [B, D] in x's dtype, k_cache, v_cache). ``timeline``, an int64
    [grid, TIMELINE_SLOTS] tensor on the card, makes a timed launch: each
    block records SM cycles at its phase and barrier ends
    (``phase_breakdown``)."""
    if not x.is_cuda:
        rows = (packed.plain_rows() if isinstance(packed, SubtalkerPack)
                else unpack_subtalker_weights(packed))
        return subtalker_step_rows(rows, x, cos, sin, k_cache, v_cache, pos, eps)

    _check_call(packed, x, cos, sin, k_cache, v_cache, pos, timeline)
    b = x.shape[0]
    out = torch.empty_like(x)
    w = packed._ptrs  # wqkv, qkv_s, wo, wo_s, wgu, gu_s, down, down_s, the 4 norms
    err = _kernel_fn("step")(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), *w, k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), packed.scratch(b).data_ptr(),
        None if timeline is None else timeline.data_ptr(), _DTYPES[x.dtype], b,
        k_cache.shape[2], int(pos), float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"subtalker_step kernel launch failed: cudaError {err}")
    subtalker_step.launches += 1
    return out, k_cache, v_cache


subtalker_step.launches = 0

# The phases of a layer, each followed by a grid barrier (none after the
# last layer's down projection).
PHASES = ("qkv", "attention", "o_proj", "gate_up", "down")


def phase_breakdown(timeline: torch.Tensor) -> dict:
    """Where a timed launch's time went, averaged over the blocks, in us:
    per phase kind its work (from the barrier before it to its end, summed
    over the layers) and the barrier after it (from its end until every
    block has arrived), the block's whole span, and the time the consumers
    waited for weights and the producer for free ring stages. The cycle rate
    comes from the global timer over each block's span."""
    t = timeline.cpu().double()
    span = t[:, 62] - t[:, 0]
    us_per_cycle = ((t[:, 63] - t[:, 1]) / span / 1e3).mean().item()
    marks = torch.cat([t[:, :1], t[:, 2:51]], dim=1)  # start, then 49 marks
    steps = (marks[:, 1:] - marks[:, :-1]).mean(0) * us_per_cycle  # 49 intervals
    out = {f"{k}_{part}": 0.0 for k in PHASES for part in ("work", "barrier")}
    for i, dt in enumerate(steps.tolist()):
        out[f"{PHASES[(i // 2) % 5]}_{'barrier' if i % 2 else 'work'}"] += dt
    out.update(span=span.mean().item() * us_per_cycle,
               wait_weights=t[:, 60].mean().item() * us_per_cycle,
               wait_stages=t[:, 61].mean().item() * us_per_cycle,
               mhz=1 / us_per_cycle)
    return out
