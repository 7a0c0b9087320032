"""EMA vector-quantizer training, the 25 Hz tokenizer's VQ learning stage
(PyTorch counterpart of ``qwen_tts_tpu/training/vq.py``).

State is stacked ``[G, Q, ...]`` codebook buffers (``VQState``); one train
step is ``(state, params, x, generator) -> (state', out)`` and returns new
tensors. The residual loop over quantizers and the group split of GRVQ are
Python loops. Data parallelism: ``vq_train_step`` takes a
``torch.distributed`` process group where the JAX function takes a mesh axis
name, the batch split over its ranks. The per-batch statistics (counts and
per-code embedding sums) are all-reduced before the EMA update, k-means
init runs on every rank's rows, and dead-code replacements and the
quantize-dropout cap are rank 0's, so every rank keeps the same buffers,
those of the full-batch step (``make_sharded_vq_train_step``).

As in the JAX package: channels-last ``[B, T, D]``, the group split over
features, the nearest code by the reference's negated squared distance and
the first of equal maxima, a quantizer that quantize dropout drops leaves
its buffers as they were. Where JAX draws from a key, the port draws from
the ``torch.Generator`` passed in (on the data's device): the sampled rows
of k-means init and dead-code expiry, and the quantize-dropout cap; the
draws differ from JAX's, their semantics do not.

The EMA statistics are scatter-adds (``index_add_``), which use float
atomics on the card; run a step under ``torch.use_deterministic_algorithms``
(``training.sft.step_mode``) for the same bits run to run.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from qwen_tts_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class VQTrainConfig:
    """The knobs of the reference's VQ constructors."""

    dim: int                      # input feature width (per group: dim // G)
    codebook_size: int
    codebook_dim: Optional[int] = None   # None → dim // num_groups (no projection)
    num_quantizers: int = 1
    num_groups: int = 1
    decay: float = 0.99
    epsilon: float = 1e-5
    kmeans_init: bool = True
    kmeans_iters: int = 50
    threshold_ema_dead_code: float = 2.0
    commitment_weight: float = 1.0
    quantize_dropout: bool = False
    rand_num_quant: Optional[Tuple[int, ...]] = None
    q0_ds_ratio: int = 1          # quantizer 0's time downsampling

    def __post_init__(self):
        if self.dim % self.num_groups:
            raise ValueError("dim must divide evenly into num_groups")

    @property
    def group_dim(self) -> int:
        return self.dim // self.num_groups

    @property
    def cb_dim(self) -> int:
        return self.codebook_dim if self.codebook_dim is not None else self.group_dim

    @property
    def has_projection(self) -> bool:
        return self.cb_dim != self.group_dim


class VQState(NamedTuple):
    """EMA codebook buffers, stacked ``[G, Q, ...]``."""

    inited: torch.Tensor        # [G, Q] bool
    cluster_size: torch.Tensor  # [G, Q, N] f32
    embed: torch.Tensor         # [G, Q, N, Dc] f32
    embed_avg: torch.Tensor     # [G, Q, N, Dc] f32


class VQOutput(NamedTuple):
    quantized: torch.Tensor     # [B, T, dim]; straight-through in training
    indices: torch.Tensor       # [G, Q, B, T] int64; -1 where dropped out
    loss: torch.Tensor          # [Q] commitment loss (mean over groups)


# --------------------------------------------------------------------------
# init


def _uniform(generator: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (2 * bound) - bound).to(device)


def init_vq_state(cfg: VQTrainConfig, generator: Optional[torch.Generator] = None,
                  device=None) -> VQState:
    """Zero buffers awaiting k-means init, or (``kmeans_init`` off)
    codebooks U(±sqrt(6 / Dc)), ``kaiming_uniform_``'s default."""
    g, q, n, d = cfg.num_groups, cfg.num_quantizers, cfg.codebook_size, cfg.cb_dim
    if cfg.kmeans_init:
        device = device if device is not None else (
            generator.device if generator is not None else "cpu")
        embed = torch.zeros((g, q, n, d), device=device)
        inited = torch.zeros((g, q), dtype=torch.bool, device=device)
    else:
        if generator is None:
            raise ValueError("uniform init needs a generator")
        device = device if device is not None else generator.device
        embed = _uniform(generator, (g, q, n, d), (6.0 / d) ** 0.5, device)
        inited = torch.ones((g, q), dtype=torch.bool, device=device)
    return VQState(inited=inited, cluster_size=torch.zeros((g, q, n), device=device),
                   embed=embed, embed_avg=embed.clone())


def init_vq_params(cfg: VQTrainConfig, generator: torch.Generator,
                   device=None) -> Optional[dict]:
    """Each quantizer's project_in / project_out Linear (torch's default
    init, U(±1/sqrt(fan_in))), or None when the codebook width is the group
    width."""
    if not cfg.has_projection:
        return None
    device = device if device is not None else generator.device
    g, q, dg, dc = cfg.num_groups, cfg.num_quantizers, cfg.group_dim, cfg.cb_dim
    lim_in, lim_out = dg ** -0.5, dc ** -0.5
    return {
        "in_w": _uniform(generator, (g, q, dg, dc), lim_in, device),
        "in_b": _uniform(generator, (g, q, dc), lim_in, device),
        "out_w": _uniform(generator, (g, q, dc, dg), lim_out, device),
        "out_b": _uniform(generator, (g, q, dg), lim_out, device),
    }


# --------------------------------------------------------------------------
# collectives of a data-parallel step (no group: one device)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks (JAX: ``lax.psum``)."""
    return x if group is None else comm.all_reduce(x.contiguous().clone(), group)


def _all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's ranks (JAX: ``lax.pmean``); its gradient
    reaches this rank's ``x`` as 1 / ranks."""
    if group is None:
        return x
    n = comm.group_size(group)
    mean = _all_reduce(x.detach(), group) / n
    return x / n + (mean - x / n).detach()


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order (JAX:
    ``lax.all_gather``); every rank holds as many."""
    return x if group is None else comm.gather(x.contiguous(), group, 0)


def _rank0(x: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's value on every rank."""
    if group is None:
        return x
    out = x.contiguous().clone() if comm.group_rank(group) == 0 else torch.zeros_like(x)
    return comm.all_reduce(out, group)


# --------------------------------------------------------------------------
# primitives


def _sample_vectors(generator: torch.Generator, samples: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` random rows of [M, D]: a permutation's prefix when M >= num,
    else drawn with replacement."""
    m = samples.shape[0]
    if m >= num:
        idx = torch.randperm(m, generator=generator, device=generator.device)[:num]
    else:
        idx = torch.randint(0, m, (num,), generator=generator, device=generator.device)
    return samples[idx.to(samples.device)]


def _nearest_code(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """The argmax of the negated squared distance as the reference forms it,
    so that the first of equal maxima wins."""
    dist = -((x * x).sum(-1, keepdim=True) - 2.0 * x @ embed.T
             + (embed * embed).sum(-1)[None, :])
    return dist.argmax(dim=-1)


def _bins(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape[0], device=idx.device))


def kmeans(generator: torch.Generator, samples: torch.Tensor, num_clusters: int,
           num_iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means over [M, D] rows: random-row init, hard assignment, an empty
    cluster keeps its previous mean. Returns (means [N, D], bins [N])."""
    means = _sample_vectors(generator, samples, num_clusters)
    for _ in range(num_iters):
        buckets = _nearest_code(samples, means)
        bins = _bins(buckets, num_clusters)
        sums = torch.zeros((num_clusters, samples.shape[-1]), dtype=samples.dtype,
                           device=samples.device).index_add_(0, buckets, samples)
        new_means = sums / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, _bins(_nearest_code(samples, means), num_clusters)


def _project(x: torch.Tensor, params: Optional[dict], w: str, b: str) -> torch.Tensor:
    return x if params is None else x @ params[w] + params[b]


# --------------------------------------------------------------------------
# one quantizer layer, one train step


def _layer_train(x_in: torch.Tensor, layer_state: tuple, layer_params: Optional[dict],
                 generator: torch.Generator, active: bool, cfg: VQTrainConfig, group):
    """One quantizer's forward and EMA update on flattened rows [M, Dg].
    Returns (new state (inited, cluster_size, embed, embed_avg), quantized
    [M, Dg], indices [M], commitment loss)."""
    if not active:  # quantize dropout: no output, the buffers stay
        return (layer_state, torch.zeros_like(x_in),
                torch.full(x_in.shape[:1], -1, dtype=torch.long, device=x_in.device),
                torch.zeros((), device=x_in.device))
    inited, cluster_size, embed, embed_avg = layer_state
    x_live = _project(x_in, layer_params, "in_w", "in_b")
    x = x_live.detach()  # the statistics and the code choice carry no gradient

    # k-means init on the first batch, over every rank's rows.
    if cfg.kmeans_init and not bool(inited):
        embed, cluster_size = kmeans(generator, _all_gather_rows(x, group),
                                     cfg.codebook_size, cfg.kmeans_iters)
        embed_avg = embed
        inited = torch.ones_like(inited)

    # Dead-code expiry before quantizing, on the synced statistics; the
    # replacement rows are rank 0's. A codebook whose statistics are all
    # zero is never expired (the reference's 0/0 compares False).
    if cfg.threshold_ema_dead_code > 0:
        total = cluster_size.sum()
        frac = cluster_size / total.clamp(min=1e-12) * cfg.codebook_size
        expired = frac < cfg.threshold_ema_dead_code
        repl = _rank0(_sample_vectors(generator, x, cfg.codebook_size), group)
        if bool(total > 0):
            embed = torch.where(expired[:, None], repl, embed)

    idx = _nearest_code(x, embed)
    quant = embed[idx]

    counts = _all_reduce(_bins(idx, cfg.codebook_size), group)
    embed_sum = _all_reduce(
        torch.zeros((cfg.codebook_size, x.shape[-1]), device=x.device).index_add_(0, idx, x),
        group)
    d = cfg.decay
    new_cluster = cluster_size * d + counts * (1.0 - d)
    new_avg = embed_avg * d + embed_sum * (1.0 - d)
    total = new_cluster.sum()
    smoothed = ((new_cluster + cfg.epsilon)
                / (total + cfg.codebook_size * cfg.epsilon) * total)
    normalized = new_avg / smoothed[:, None]

    # Straight-through estimator and commitment loss.
    quant_st = x_live + (quant - x_live).detach()
    commit = _all_mean(((quant - x_live) ** 2).mean(), group)
    out = _project(quant_st, layer_params, "out_w", "out_b")
    return ((inited, new_cluster, normalized, new_avg), out, idx,
            commit * cfg.commitment_weight)


def _layer_encode(x_in: torch.Tensor, embed: torch.Tensor, layer_params) -> torch.Tensor:
    return _nearest_code(_project(x_in, layer_params, "in_w", "in_b"), embed)


def _layer_decode(idx: torch.Tensor, embed: torch.Tensor, layer_params) -> torch.Tensor:
    return _project(embed[idx.clamp(min=0)], layer_params, "out_w", "out_b")


def _interp_nearest(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch's ``interpolate(mode='nearest')`` over axis 1 of [B, T, ...]
    (src = floor(i * in / out)), as the JAX package forms it."""
    t_in = x.shape[1]
    src = torch.floor(torch.arange(out_len, device=x.device) * (t_in / out_len)).long()
    return x[:, src.clamp(0, t_in - 1)]


def _at(tree, g: int, q: int):
    return None if tree is None else {k: v[g, q] for k, v in tree.items()}


# --------------------------------------------------------------------------
# residual VQ over one group


def _rvq_train_group(state: VQState, params: Optional[dict], g: int, x: torch.Tensor,
                     generator: torch.Generator, n_active: int, cfg: VQTrainConfig, group):
    """Group ``g``'s residual quantizers over x [B, T, Dg]. Returns (each
    quantizer's new buffers, the quantized sum [B, T, Dg], indices
    [Q, B, T], commitment losses [Q])."""
    b, t, dg = x.shape
    residual = x.reshape(b * t, dg)
    quant_sum = torch.zeros_like(residual)
    new_states, idxs, commits = [], [], []
    for q in range(cfg.num_quantizers):
        layer_state = tuple(s[g, q] for s in state)
        if q == 0 and cfg.q0_ds_ratio > 1:
            # Quantizer 0 runs on a time-downsampled residual; its output and
            # indices are upsampled back. It is never dropped.
            t_ds = t // cfg.q0_ds_ratio
            x_ds = _interp_nearest(residual.reshape(b, t, dg), t_ds).reshape(b * t_ds, dg)
            st, out, idx, commit = _layer_train(x_ds, layer_state, _at(params, g, q),
                                                generator, True, cfg, group)
            out = _interp_nearest(out.reshape(b, t_ds, dg), t).reshape(b * t, dg)
            idx = _interp_nearest(idx.reshape(b, t_ds), t).reshape(b * t)
        else:
            st, out, idx, commit = _layer_train(residual, layer_state, _at(params, g, q),
                                                generator, q < n_active, cfg, group)
        residual = residual - out
        quant_sum = quant_sum + out
        new_states.append(st)
        idxs.append(idx)
        commits.append(commit)
    return (new_states, quant_sum.reshape(b, t, dg), torch.stack(idxs).reshape(-1, b, t),
            torch.stack(commits))


# --------------------------------------------------------------------------
# public API


def _stack_state(per_group: List[list]) -> VQState:
    """[G][Q] tuples of buffers → VQState of [G, Q, ...] tensors."""
    return VQState(*(torch.stack([torch.stack([st[i] for st in layers]) for layers in per_group])
                     for i in range(4)))


def vq_train_step(state: VQState, params: Optional[dict], x: torch.Tensor,
                  generator: torch.Generator, *, cfg: VQTrainConfig, n_q: Optional[int] = None,
                  group=None) -> Tuple[VQState, VQOutput]:
    """One training forward and EMA codebook update over every group and
    quantizer. With ``group`` (a ``torch.distributed`` process group) ``x``
    is this rank's rows of the batch: the statistics are summed over the
    group, and every rank returns the full-batch step's buffers and loss
    with its own rows' outputs."""
    g = cfg.num_groups
    b, t, _ = x.shape
    xg = x.reshape(b, t, g, cfg.group_dim)
    n_limit = n_q if n_q is not None else cfg.num_quantizers
    if cfg.quantize_dropout and cfg.rand_num_quant:
        # A random cap on the active quantizers this step, shared by every
        # group (rank 0's draw).
        pick = torch.randint(0, len(cfg.rand_num_quant), (), generator=generator,
                             device=generator.device)
        n_active = min(cfg.rand_num_quant[int(_rank0(pick, group))], n_limit)
    else:
        n_active = n_limit

    per_group = [_rvq_train_group(state, params, gi, xg[:, :, gi], generator, n_active,
                                  cfg, group) for gi in range(g)]
    new_state = _stack_state([r[0] for r in per_group])
    quant = torch.cat([r[1] for r in per_group], dim=-1)
    indices = torch.stack([r[2] for r in per_group])
    loss = torch.stack([r[3] for r in per_group]).mean(dim=0)
    return new_state, VQOutput(quant, indices, loss)


def make_sharded_vq_train_step(group, cfg: VQTrainConfig, n_q: Optional[int] = None):
    """The data-parallel train step (JAX: ``make_sharded_vq_train_step``, a
    ``shard_map`` over a mesh axis): ``step(state, params, x, generator)`` on
    this rank's rows ``x`` of the batch, with the state and params whole on
    every rank; the all-reduced statistics keep every rank's state the same
    and equal to the full-batch step's. Every rank passes a generator in the
    same state. Returns (state, VQOutput) with this rank's rows' quantized
    output and indices and the batch's loss."""

    def step(state: VQState, params: Optional[dict], x: torch.Tensor,
             generator: torch.Generator) -> Tuple[VQState, VQOutput]:
        return vq_train_step(state, params, x, generator, cfg=cfg, n_q=n_q, group=group)

    return step


def vq_encode(state: VQState, params: Optional[dict], x: torch.Tensor, *,
              cfg: VQTrainConfig, n_q: Optional[int] = None) -> torch.Tensor:
    """Residual encode, no state change. Returns [G, Q, B, T] int64."""
    b, t, _ = x.shape
    n = n_q if n_q is not None else cfg.num_quantizers
    xg = x.reshape(b, t, cfg.num_groups, cfg.group_dim)
    out = []
    for gi in range(cfg.num_groups):
        residual = xg[:, :, gi].reshape(b * t, cfg.group_dim)
        codes = []
        for q in range(n):
            embed, pr = state.embed[gi, q], _at(params, gi, q)
            idx = _layer_encode(residual, embed, pr)
            residual = residual - _layer_decode(idx, embed, pr)
            codes.append(idx)
        out.append(torch.stack(codes).reshape(n, b, t))
    return torch.stack(out)


def vq_decode(state: VQState, params: Optional[dict], indices: torch.Tensor, *,
              cfg: VQTrainConfig) -> torch.Tensor:
    """The sum of each quantizer's dequantization, groups concatenated on
    the feature axis. indices [G, Q, B, T] → [B, T, dim]."""
    g, q, b, t = indices.shape
    out = []
    for gi in range(g):
        acc = torch.zeros((b * t, cfg.group_dim), device=indices.device)
        for qi in range(q):
            acc = acc + _layer_decode(indices[gi, qi].reshape(b * t), state.embed[gi, qi],
                                      _at(params, gi, qi))
        out.append(acc.reshape(b, t, cfg.group_dim))
    return torch.cat(out, dim=-1)
