"""Supervised finetuning (SFT): Base → CustomVoice (PyTorch counterpart of
``qwen_tts_tpu/training/sft.py``).

Loss = talker cross-entropy on codebook-0 labels + 0.3 x sub-talker
cross-entropy on groups 1..G-1. The sub-talker term is the teacher-forced
micro-decode run as one batched forward over every position's frame
(``[B*S, G]`` sequences), as in the JAX package.

``make_train_step`` returns a function over a ``{"talker", "subtalker"}``
tree of leaf tensors, ``(params, opt_state, batch) -> (params, opt_state,
loss, aux)``, JAX's signature; it updates the params and the optimizer
state in place and returns them (clone a tree to keep it). On the
card a step runs in f32 without TF32 (``utils.full_f32``) and with
``torch.use_deterministic_algorithms(True)``: the embedding gathers' and the
cross-entropy's backward passes (scatter-adds) then sum in a fixed order, so
two runs of a step give the same bits and a resumed run equals an
uninterrupted one. cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` for
that, set before the process first uses it (``DETERMINISTIC_CUBLAS``).

The optimizer (``make_optimizer``) is ``optax.chain(clip_by_global_norm(c),
adamw(lr, weight_decay=wd))`` exactly: the clip scales by ``c / |g|`` only
when ``|g| >= c``, and the decay reaches every leaf, those whose gradient is
zero too (the text embedding and projection: ``collate`` builds the inputs
outside the loss). Its state is tensors: ``{"count", "mu", "nu"}``; its
``step`` applies an update in place, so that the card holds one copy of the
params and moments (0.75 B parameters at the flagship widths: 12 GB with
the gradients in f32).

On a (dp, tp) mesh (``parallel/mesh.py``) the step takes a rank's shards and
its config. Under dp each cross-entropy term is normalised by the global
mask count (the counts are all-reduced first), and the gradients, the loss
and its terms are all-reduced over dp: the loss is the single-device
batch's, up to the order of the sums; padded rows (all masked) are neutral.
Under tp the trunk's collectives make the gradients of whole leaves full on
every rank, and ``Optimizer.step``'s global norm sums the squares of the
split leaves over tp and counts whole leaves once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from qwen_tts_tpu_torch.config import TalkerConfig, placement_of
from qwen_tts_tpu_torch.models import subtalker as st_mod
from qwen_tts_tpu_torch.models import talker as talker_mod
from qwen_tts_tpu_torch.models.trunk import trunk_prefill
from qwen_tts_tpu_torch.ops.norms import rms_norm
from qwen_tts_tpu_torch.ops.rope import rope_cos_sin
from qwen_tts_tpu_torch.parallel.comm import all_reduce, copy_to_tp, gather_last_dim
from qwen_tts_tpu_torch.utils import full_f32

# The cuBLAS workspace setting that deterministic algorithms need; read when
# cuBLAS is first used, so an entry point sets it before that.
DETERMINISTIC_CUBLAS = ":4096:8"


class SFTBatch(NamedTuple):
    """One training batch. ``codec0_labels[b, t]`` is the target for the
    talker logits at position t (already shifted by the data prep); -100 =
    ignored. ``group_labels[b, t, :]`` holds the G codec ids of the frame
    whose codebook-0 token is at position t."""

    inputs_embeds: torch.Tensor  # [B, S, D]
    pad_mask: torch.Tensor       # [B, S] bool
    codec0_labels: torch.Tensor  # [B, S] int64, -100 = ignore
    group_labels: torch.Tensor   # [B, S, G] int64
    frame_mask: torch.Tensor     # [B, S] bool: positions with codec frames


def _ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
        dp_group=None) -> torch.Tensor:
    """The masked mean cross-entropy; under dp (``dp_group``) this rank's
    share of the global batch's: its sum over the global mask count."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = mask.float()
    count = mask.sum()
    if dp_group is not None:
        count = all_reduce(count.detach().clone(), dp_group)
    return -(ll * mask).sum() / count.clamp(min=1.0)


def _dp_group(cfg):
    placement = placement_of(cfg)
    return None if placement is None else placement.dp_group


def sft_loss(params: dict, cfg: TalkerConfig, batch: SFTBatch,
             remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"talker_ce", "subtalker_ce"}) of one batch; differentiable
    in ``params``. Under dp, this rank's share of the global batch's loss
    (``loss_and_grads`` sums the shares)."""
    tp, sp = params["talker"], params["subtalker"]
    dp_group = _dp_group(cfg)
    b, s, d = batch.inputs_embeds.shape
    g = cfg.num_code_groups

    # ---- talker CE --------------------------------------------------------
    positions = (torch.cumsum(batch.pad_mask.int(), dim=-1) - 1).clamp(min=0)
    cos, sin = talker_mod._mrope_cos_sin(cfg, positions)
    hidden, _, _ = trunk_prefill(
        tp["trunk"], talker_mod.talker_dims(cfg), batch.inputs_embeds, cos, sin,
        pad_mask=batch.pad_mask, remat=remat)
    hidden = rms_norm(hidden, tp["norm"], cfg.rms_norm_eps)
    logits = hidden @ tp["codec_head"]
    talker_mask = (batch.codec0_labels != -100) & batch.pad_mask
    talker_ce = _ce(logits, batch.codec0_labels, talker_mask, dp_group)

    # ---- sub-talker CE (teacher-forced, every position's frame at once) ---
    cp = cfg.code_predictor
    flat_hidden = hidden.reshape(b * s, d)
    flat_groups = batch.group_labels.reshape(b * s, g)
    seq = [flat_hidden[:, None, :],
           tp["codec_embedding"][flat_groups[:, 0]][:, None, :]]
    if g > 2:
        ids = torch.arange(g - 2, device=flat_groups.device)
        gathered = sp["embeds"][ids[:, None], flat_groups[:, 1 : g - 1].T]  # [G-2, N, D]
        seq.append(gathered.transpose(0, 1))
    st_in = st_mod._project_input(sp, torch.cat(seq, dim=1))           # [N, G, D]
    st_pos = torch.arange(g, device=st_in.device)[None].expand(b * s, g)
    st_cos, st_sin = rope_cos_sin(st_pos, cp.head_dim, cp.rope_theta)
    st_dims = st_mod.subtalker_dims(cp)
    st_hidden, _, _ = trunk_prefill(sp["trunk"], st_dims, st_in, st_cos, st_sin, remat=remat)
    st_hidden = rms_norm(st_hidden, sp["norm"], cp.rms_norm_eps)
    # Position i (1..G-1) predicts group i through lm_heads[i-1] (under tp
    # the rank's vocab slice, the logits gathered).
    st_logits = gather_last_dim(torch.einsum(
        "nid,idv->niv", copy_to_tp(st_hidden[:, 1:], st_dims.group), sp["lm_heads"]),
        st_dims.group)
    st_labels = flat_groups[:, 1:]
    st_mask = batch.frame_mask.reshape(b * s)[:, None].expand(st_labels.shape)
    st_ce = _ce(st_logits, st_labels, st_mask, dp_group)

    loss = talker_ce + 0.3 * st_ce
    return loss, {"talker_ce": talker_ce, "subtalker_ce": st_ce}


# --------------------------------------------------------------------------
# Trees of leaf tensors
# --------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    """The paths (``talker/trunk/wq``) of ``tree_leaves``' leaves, in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}/{k}" if prefix
                                                             else str(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]


def tree_unflatten(tree, leaves: Iterator[torch.Tensor]):
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator over what ``tree_leaves`` gives)."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return next(leaves)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree), *map(tree_leaves, rest))]
    return tree_unflatten(tree, iter(leaves))


# --------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adamw)
# --------------------------------------------------------------------------

# optax.adamw's defaults, which the JAX package's training keeps.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class Optimizer(NamedTuple):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=weight_decay))``: ``init(params) -> state``, and ``step``,
    which applies one update to ``params`` and ``state`` in place (optax's
    ``update`` and ``apply_updates`` in one; in place, so that the card holds
    one copy of the params and moments, not two)."""

    lr: float
    weight_decay: float = 1e-4  # optax.adamw's default
    grad_clip: float = 1.0

    def init(self, params) -> dict:
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def step(self, grads, state: dict, params, sharding=None) -> None:
        """One update of ``params`` and ``state`` (in place) by ``grads``, a
        tree of the params' structure. Each leaf is updated in pieces of at
        most ``_PIECE`` elements, so the update's temporaries stay small
        beside the params (the text embedding alone is 1.2 GB at the
        flagship widths); the update is elementwise, so the pieces give the
        whole leaf's bits. Under tp, ``sharding`` (``mesh.ParamSharding``)
        names the split leaves: the global norm sums their squares over the
        tp group and counts whole leaves, the same on every rank, once."""
        flat = tree_leaves(grads)
        # clip_by_global_norm: (g / |g|) * c where |g| >= c, else g.
        squares = [sum((g * g).sum() for (g,) in _pieces(leaf)) for leaf in flat]
        if sharding is None:
            g_norm = torch.sqrt(sum(squares))
        else:
            split = [sharding.axis(path) is not None for path in tree_paths(grads)]
            whole = sum(sq for sq, sp in zip(squares, split) if not sp)
            parts = sum(sq for sq, sp in zip(squares, split) if sp)
            parts = all_reduce(torch.as_tensor(parts, device=flat[0].device).clone(),
                               sharding.group)
            g_norm = torch.sqrt(whole + parts)
        clip = g_norm >= self.grad_clip
        # scale_by_adam, then add_decayed_weights, then scale by -lr and add.
        state["count"].add_(1)
        count = state["count"]
        c1 = 1 - torch.tensor(_B1, device=count.device) ** count
        c2 = 1 - torch.tensor(_B2, device=count.device) ** count
        for leaves in zip(flat, tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                          tree_leaves(params)):
            for g, m, v, p in _pieces(*leaves):
                g = torch.where(clip, (g / g_norm) * self.grad_clip, g)
                m.copy_((1 - _B1) * g + _B1 * m)
                v.copy_((1 - _B2) * (g * g) + _B2 * v)
                u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + _EPS)
                p.copy_(p + -self.lr * (u + self.weight_decay * p))


# Elements in a piece of a leaf that the optimizer updates at once.
_PIECE = 1 << 24


def _pieces(grad: torch.Tensor, *state: torch.Tensor):
    """Matching flat views of at most ``_PIECE`` elements: of ``grad`` (read
    only, so a copy where it is not contiguous) and of the leaves that are
    updated in place, which must be contiguous."""
    if any(not t.is_contiguous() for t in state):
        raise ValueError("the optimizer updates contiguous params and moments in place")
    flat = [grad.reshape(-1)] + [t.view(-1) for t in state]
    for start in range(0, flat[0].numel(), _PIECE):
        yield tuple(t[start : start + _PIECE] for t in flat)


def make_optimizer(lr: float, weight_decay: float = 1e-4, grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------

@contextlib.contextmanager
def step_mode(device: torch.device) -> Iterator[None]:
    """How a step runs on ``device``: on the card, f32 without TF32 and
    deterministic algorithms (both restored on exit); on the CPU, as it is
    (its kernels are deterministic). Without ``CUBLAS_WORKSPACE_CONFIG``
    torch refuses the step's first cuBLAS call on the card."""
    if device.type != "cuda":
        yield
        return
    before = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with full_f32():
            yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn_only)


def loss_and_grads(params: dict, cfg: TalkerConfig, batch: SFTBatch, remat: bool = False):
    """(loss, aux, grads) of ``sft_loss``; a leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it. Under dp the gradients,
    the loss and its terms are summed over the dp group: the global batch's."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, iter(leaves))
    with torch.enable_grad():
        loss, aux = sft_loss(live, cfg, batch, remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    dp_group = _dp_group(cfg)
    if dp_group is not None:
        # A leaf the loss does not reach is unreached on every rank (the
        # ranks run one graph): its zeros need no all-reduce.
        grads = [None if g is None else g.contiguous() for g in grads]
        for g in (loss, *aux.values(), *grads):
            if g is not None:
                all_reduce(g, dp_group)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss, aux, tree_unflatten(params, iter(grads))


def make_train_step(cfg: TalkerConfig, optimizer: Optimizer, remat: bool = False,
                    sharding=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    aux)``: the trees passed in, updated in place, and returned. ``remat``
    recomputes every trunk layer in the backward pass (``trunk_prefill``):
    lower peak memory for a second forward, the same values. On a mesh,
    ``cfg`` and the trees are a rank's (``shard_params``), ``batch`` its rows
    and ``sharding`` the split leaves."""

    def train_step(params: dict, opt_state: dict, batch: SFTBatch):
        with step_mode(batch.inputs_embeds.device):
            loss, aux, grads = loss_and_grads(params, cfg, batch, remat)
            optimizer.step(grads, opt_state, params, sharding)
        return params, opt_state, loss, aux

    return train_step
