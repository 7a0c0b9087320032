"""The (dp, tp) device mesh and the tensor-parallel plan (the counterpart of
``qwen_tts_tpu/parallel/mesh.py``).

The JAX package lays a ``Mesh`` over ("dp", "tp") and annotates global
arrays with shardings; XLA inserts the collectives. Here each rank holds its
own shards and runs the trunk on them, and the trunk calls the collectives
itself (``parallel/comm.py``) through the tp group its dims carry.

The plan (``TRUNK_PLAN``, ``SUBTALKER_PLAN``) on the stacked ``[L, in, out]``
layouts, the reference's declared TP plan:

* colwise (q/k/v/gate/up): split the **out** axis over tp;
* rowwise (o/down): split the **in** axis;
* norms, embeddings, the codec head and the text projection: whole;
* the sub-talker's stacked LM heads ``[G-1, D, V]``: split V (their logits
  are gathered);
* the batch of activations and KV caches: rows over dp (``shard_rows``).

KV caches split their heads over tp where the KV heads divide; otherwise
each rank keeps ``wk`` / ``wv`` whole and caches the KV heads its q heads
map to (``kv_cache_heads``). The JAX plan names only the float keys, so a
trunk read from int8 or fused keys (``*_i8``, ``wqkv``, ``wgu``, a
sub-talker's ``trunk_packed``) stays whole on every rank and runs with no
collective, the replicated placement JAX gives those leaves; so do int8 LM
heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from qwen_tts_tpu_torch.config import Placement, TalkerConfig
from qwen_tts_tpu_torch.parallel import comm

# Axis of each trunk key split over tp (None: whole on every rank).
TRUNK_PLAN: Dict[str, Optional[int]] = {
    "wq": -1, "wk": -1, "wv": -1, "gate": -1, "up": -1,
    "wo": -2, "down": -2,
    "input_norm": None, "post_attn_norm": None, "q_norm": None, "k_norm": None,
}
# The sub-talker's keys outside its trunk; the rest (tables, norm, input
# projection) are whole.
SUBTALKER_PLAN: Dict[str, Optional[int]] = {"lm_heads": -1}
# Keys that make a trunk whole on every rank (the JAX plan names none).
_WHOLE_KEYS = ("wqkv", "wgu")


def make_mesh(n_devices: Optional[int] = None, tp: int = 1):
    """A ``DeviceMesh`` over ("dp", "tp") on the initialized process group
    (``init_multihost``): ranks ``dp_index * tp + tp_index``, so a tp group
    is ``tp`` consecutive ranks. ``n_devices`` defaults to the world size
    and must equal it. Raises as JAX does when ``tp`` does not divide it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks")
    if n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


class MeshPlace(NamedTuple):
    """This rank's coordinates in a mesh and the groups along its axes."""

    dp_group: object
    dp_rank: int
    dp_size: int
    tp_group: object
    tp_rank: int
    tp_size: int


def mesh_place(mesh) -> MeshPlace:
    """This rank's ``MeshPlace`` in a ``make_mesh`` mesh."""
    dp, tp = mesh.shape
    return MeshPlace(mesh.get_group("dp"), mesh.get_local_rank("dp"), dp,
                     mesh.get_group("tp"), mesh.get_local_rank("tp"), tp)


def kv_cache_heads(tp_rank: int, tp_size: int, heads: int, kv_heads: int) -> Tuple[int, int]:
    """The KV heads [first, end) a rank caches (``kv_cache_sharding``):
    ``kv_heads / tp`` of them where tp divides them; otherwise the heads the
    rank's q heads map to (GQA maps q head i to KV head i // (H / KV)). The
    rank's q heads must then map evenly onto them: raises where they do not."""
    if kv_heads % tp_size == 0:
        n = kv_heads // tp_size
        return tp_rank * n, (tp_rank + 1) * n
    group, h_r = heads // kv_heads, heads // tp_size
    if group % h_r and h_r % group:
        raise ValueError(f"{heads} q heads over tp={tp_size} do not map evenly onto "
                         f"{kv_heads} KV heads")
    return tp_rank * h_r // group, ((tp_rank + 1) * h_r - 1) // group + 1


def _split(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    width = x.shape[dim] // size
    return x.narrow(dim, rank * width, width).contiguous()


def _kv_columns(x: torch.Tensor, first: int, end: int, head_dim: int) -> torch.Tensor:
    return x[..., first * head_dim: end * head_dim].contiguous()


def _is_whole(trunk: dict) -> bool:
    return any(k.endswith("_i8") for k in trunk) or any(k in trunk for k in _WHOLE_KEYS)


class ParamSharding(NamedTuple):
    """Which leaves of a ``{"talker", "subtalker"}`` tree a rank holds split
    over tp, by path (``talker/trunk/wq``) and axis. ``shard`` cuts a whole
    leaf to the rank's slice; ``gather`` (a collective over the tp group:
    every rank of it calls it) rebuilds the whole leaf. A path matches a key
    where it is the key or ends with ``/key`` (an optimizer's moments hold
    the params' paths under ``mu/`` and ``nu/``)."""

    dims: Dict[str, int]
    group: object
    rank: int
    size: int

    def axis(self, path: str) -> Optional[int]:
        for key, dim in self.dims.items():
            if path == key or path.endswith("/" + key):
                return dim
        return None

    def shard(self, path: str, x: torch.Tensor) -> torch.Tensor:
        dim = self.axis(path)
        return x if dim is None else _split(x, dim, self.rank, self.size)

    def gather(self, path: str, x: torch.Tensor) -> torch.Tensor:
        dim = self.axis(path)
        return x if dim is None else comm.gather(x.contiguous(), self.group, dim)

    def map_tree(self, fn, tree, prefix: str = ""):
        """``fn(path, leaf)`` over a tree of dicts (and lists) of tensors."""
        if isinstance(tree, dict):
            return {k: self.map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        return fn(prefix, tree)

    def gather_tree(self, tree, prefix: str = ""):
        return self.map_tree(self.gather, tree, prefix)

    def shard_tree(self, tree, prefix: str = ""):
        return self.map_tree(self.shard, tree, prefix)


class Shards(NamedTuple):
    """``shard_params``' result: the rank's talker and sub-talker trees, the
    rank's config (its heads, KV heads and intermediate width, and the
    ``Placement`` through which the trunk functions reach the tp group:
    ``talker_dims(cfg)`` / ``subtalker_dims(cfg.code_predictor)`` give the
    rank's ``TrunkDims``) and the leaves split over tp."""

    talker: dict
    subtalker: dict
    cfg: TalkerConfig
    sharding: ParamSharding


def _rank_trunk(trunk: dict, cfg, place: MeshPlace, prefix: str, split: dict):
    """The rank's trunk, its config and its placement; ``split`` collects
    the split leaves' paths."""
    heads, kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    base = Placement(dp_group=place.dp_group, dp_rank=place.dp_rank, dp_size=place.dp_size)
    if _is_whole(trunk):
        return trunk, dataclasses.replace(cfg, placement=base), False
    tp, r = place.tp_size, place.tp_rank
    for what, n in (("heads", heads), ("intermediate", cfg.intermediate_size)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the {what} ({n}) of {cfg!r}")
    first, end = kv_cache_heads(r, tp, heads, kv)
    kv_whole = kv % tp != 0
    out = {}
    for key, x in trunk.items():
        dim = TRUNK_PLAN.get(key)
        if dim is None or (kv_whole and key in ("wk", "wv")):
            out[key] = x
        else:
            out[key] = _split(x, dim, r, tp)
            split[f"{prefix}/{key}"] = dim
    rank_cfg = dataclasses.replace(
        cfg, num_attention_heads=heads // tp, num_key_value_heads=end - first,
        intermediate_size=cfg.intermediate_size // tp,
        placement=dataclasses.replace(base, tp_group=place.tp_group, tp_rank=r, tp_size=tp,
                                      kv_slice=(first, end) if kv_whole else None))
    return out, rank_cfg, True


def shard_params(mesh, talker_params: dict, st_params: dict, cfg: TalkerConfig) -> Shards:
    """This rank's shards of the talker and sub-talker trees under the plan,
    with the rank's config. Raises ``ValueError`` naming the config where tp
    does not divide the heads or the intermediate width (JAX's
    ``device_put`` also refuses an uneven split). Whole leaves are the
    caller's tensors, not copies."""
    place = mesh_place(mesh)
    split: Dict[str, int] = {}
    talker = dict(talker_params)
    talker["trunk"], t_cfg, _ = _rank_trunk(talker_params["trunk"], cfg, place,
                                            "talker/trunk", split)
    st = dict(st_params)
    cp = cfg.code_predictor
    if "trunk" in st_params:
        st["trunk"], cp, st_split = _rank_trunk(st_params["trunk"], cp, place,
                                                "subtalker/trunk", split)
    else:  # the serving mode's pack: whole
        cp = dataclasses.replace(cp, placement=Placement(
            dp_group=place.dp_group, dp_rank=place.dp_rank, dp_size=place.dp_size))
        st_split = False
    if st_split and "lm_heads" in st_params:
        if cp.vocab_size % place.tp_size:
            raise ValueError(f"tp={place.tp_size} does not divide the sub-talker vocab "
                             f"({cp.vocab_size})")
        for key, dim in SUBTALKER_PLAN.items():
            st[key] = _split(st_params[key], dim, place.tp_rank, place.tp_size)
            split[f"subtalker/{key}"] = dim
    rank_cfg = dataclasses.replace(t_cfg, code_predictor=cp)
    return Shards(talker, st, rank_cfg,
                  ParamSharding(split, place.tp_group, place.tp_rank, place.tp_size))


def shard_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This dp rank's rows of a global batch (``batch_sharding``): the
    leading axis split evenly over dp, each row as it is in the global
    batch (its left padding too)."""
    place = mesh_place(mesh)
    if x.shape[0] % place.dp_size:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over dp={place.dp_size}")
    return _split(x, 0, place.dp_rank, place.dp_size)


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every dp rank's rows, in rank order: the global batch (a collective
    over the dp group)."""
    return comm.gather(x.contiguous(), mesh_place(mesh).dp_group, 0)
