"""The port's (dp, tp) plan (``qwen_tts_tpu_torch/parallel/mesh.py``)
against the JAX package's shardings, without a process group: which axis
each key splits, the shards' shapes and the rank's config, the trunks that
stay whole (int8, fused), the KV heads a rank caches, and the refusals."""

import dataclasses

import numpy as np
import pytest
import torch

from qwen_tts_tpu.config import tiny_tts_config
from qwen_tts_tpu.parallel import mesh as j_mesh
from qwen_tts_tpu_torch.config import CodePredictorConfig, TalkerConfig
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.models.trunk import fuse_trunk_params, quantize_trunk_int8
from qwen_tts_tpu_torch.parallel import mesh as t_mesh

CFG = tiny_tts_config()


def _port_cfg(**talker) -> TalkerConfig:
    d = {f.name: getattr(CFG.talker, f.name) for f in dataclasses.fields(CFG.talker)}
    cp = CFG.talker.code_predictor
    d["code_predictor"] = CodePredictorConfig(
        **{f.name: getattr(cp, f.name) for f in dataclasses.fields(cp)})
    d.update(talker)
    return TalkerConfig(**d)


def _trees(cfg):
    g = torch.Generator().manual_seed(0)
    return (t_talker.init_talker_params(g, cfg),
            t_st.init_subtalker_params(g, cfg.code_predictor, cfg.hidden_size))


class _Mesh:
    """What ``mesh_place`` reads of a ``make_mesh`` mesh, for one rank of a
    mesh that no process group backs (no groups: nothing is reduced)."""

    def __init__(self, tp_rank, tp, dp_rank, dp):
        self.shape = (dp, tp)
        self._ranks = {"dp": dp_rank, "tp": tp_rank}

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self._ranks[name]


def _place(tp_rank=0, tp=2, dp_rank=0, dp=1):
    return _Mesh(tp_rank, tp, dp_rank, dp)


def _axis(spec, ndim=3):
    """The axis a JAX PartitionSpec splits over "tp", as a negative index."""
    for i, name in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if name == "tp":
            return i - ndim
    return None


def test_plan_matches_jax_shardings():
    jm = j_mesh.make_mesh(2, tp=2)
    for key, sharding in j_mesh.trunk_shardings(jm).items():
        assert t_mesh.TRUNK_PLAN[key] == _axis(sharding.spec), key
    # q/k norms: whole in both (the JAX plan replicates every unnamed leaf).
    assert t_mesh.TRUNK_PLAN["q_norm"] is None and t_mesh.TRUNK_PLAN["k_norm"] is None
    st = {"trunk": {"wq": np.zeros((1, 2, 2))}, "lm_heads": np.zeros((1, 2, 2)),
          "norm": np.zeros(2)}
    spec = j_mesh.subtalker_shardings(jm, st)
    assert t_mesh.SUBTALKER_PLAN == {"lm_heads": _axis(spec["lm_heads"].spec)}
    assert _axis(spec["norm"].spec, 1) is None


@pytest.mark.parametrize("tp_rank", [0, 1])
def test_shards_and_rank_config(tp_rank):
    cfg = _port_cfg()
    talker, st = _trees(cfg)
    shards = t_mesh.shard_params(_place(tp_rank), talker, st, cfg)
    tk, cp = CFG.talker, CFG.talker.code_predictor
    r = shards.cfg
    assert (r.num_attention_heads, r.num_key_value_heads, r.intermediate_size) == (
        tk.num_attention_heads // 2, tk.num_key_value_heads // 2, tk.intermediate_size // 2)
    assert (r.code_predictor.num_attention_heads, r.code_predictor.intermediate_size) == (
        cp.num_attention_heads // 2, cp.intermediate_size // 2)
    assert r.placement.tp_rank == tp_rank and r.placement.kv_slice is None
    for tree, full in ((shards.talker["trunk"], talker["trunk"]),
                       (shards.subtalker["trunk"], st["trunk"])):
        for key, x in full.items():
            dim = t_mesh.TRUNK_PLAN[key]
            if dim is None:
                assert tree[key] is x
                continue
            width = x.shape[dim] // 2
            assert torch.equal(tree[key], x.narrow(dim, tp_rank * width, width))
    v = cp.vocab_size // 2
    assert torch.equal(shards.subtalker["lm_heads"], st["lm_heads"][..., tp_rank * v:(tp_rank + 1) * v])
    for key in ("codec_embedding", "text_embedding", "codec_head", "text_proj_fc1", "norm"):
        assert shards.talker[key] is talker[key]
    assert shards.subtalker["embeds"] is st["embeds"]
    assert set(shards.sharding.dims) == (
        {f"talker/trunk/{k}" for k, d in t_mesh.TRUNK_PLAN.items() if d is not None}
        | {f"subtalker/trunk/{k}" for k, d in t_mesh.TRUNK_PLAN.items() if d is not None}
        | {"subtalker/lm_heads"})
    # The rank's dims carry its heads; the rank's cache its KV heads.
    dims = t_talker.talker_dims(r)
    assert (dims.heads, dims.kv_heads) == (tk.num_attention_heads // 2, tk.num_key_value_heads // 2)
    k, _ = t_talker.alloc_kv_cache(r, 2, 8)
    assert k.shape[3] == tk.num_key_value_heads // 2
    # shard and gather paths of an optimizer's moments match the params'.
    assert shards.sharding.axis("mu/talker/trunk/wo") == -2
    assert shards.sharding.axis("talker/trunk/input_norm") is None


def test_int8_and_fused_trunks_stay_whole():
    cfg = _port_cfg()
    talker, st = _trees(cfg)
    for make in (quantize_trunk_int8, fuse_trunk_params,
                 lambda t: quantize_trunk_int8(fuse_trunk_params(t))):
        t2 = dict(talker, trunk=make(talker["trunk"]))
        s2 = dict(st, trunk=make(st["trunk"]))
        shards = t_mesh.shard_params(_place(1), t2, s2, cfg)
        assert shards.talker["trunk"] is t2["trunk"] and shards.subtalker["trunk"] is s2["trunk"]
        assert shards.subtalker["lm_heads"] is st["lm_heads"]
        for part in (shards.cfg, shards.cfg.code_predictor):
            assert part.placement.tp_group is None
        assert shards.cfg.num_attention_heads == CFG.talker.num_attention_heads
        assert not shards.sharding.dims


@pytest.mark.parametrize("heads,kv,tp,want", [
    (16, 2, 2, [(0, 1), (1, 2)]),                    # divides
    (16, 8, 2, [(0, 4), (4, 8)]),
    (16, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),    # 4 q heads a rank, one KV head
    (4, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),
    (12, 3, 2, None),                                # 6 q heads over groups of 4
])
def test_kv_cache_heads(heads, kv, tp, want):
    if want is None:
        with pytest.raises(ValueError, match="do not map evenly"):
            t_mesh.kv_cache_heads(0, tp, heads, kv)
        return
    assert [t_mesh.kv_cache_heads(r, tp, heads, kv) for r in range(tp)] == want


def test_whole_kv_projections_where_kv_heads_do_not_divide():
    cfg = _port_cfg()
    talker, st = _trees(cfg)
    shards = t_mesh.shard_params(_place(3, tp=4), talker, st, cfg)
    assert shards.talker["trunk"]["wk"] is talker["trunk"]["wk"]
    assert shards.cfg.placement.kv_slice == (1, 2)
    assert shards.cfg.num_key_value_heads == 1
    assert "talker/trunk/wk" not in shards.sharding.dims


def test_refusals():
    cfg = _port_cfg()
    talker, st = _trees(cfg)
    with pytest.raises(ValueError, match="does not divide the heads"):
        t_mesh.shard_params(_place(0, tp=3), talker, st, cfg)
    odd = _port_cfg(intermediate_size=130)
    t_odd, s_odd = _trees(odd)
    with pytest.raises(ValueError, match="intermediate"):
        t_mesh.shard_params(_place(0, tp=4), t_odd, s_odd, odd)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        t_mesh.shard_rows(_place(tp=1, dp=2), torch.zeros(3, 4))
    with pytest.raises(RuntimeError, match="init_multihost"):
        t_mesh.make_mesh(tp=1)


def test_shard_rows_keeps_global_padding():
    x = torch.arange(4 * 3).reshape(4, 3)
    assert torch.equal(t_mesh.shard_rows(_place(tp=1, dp_rank=1, dp=2), x), x[2:])


def _one_rank_cfg(cfg):
    """``cfg`` placed on a one-rank gloo group made without a default group
    (``ProcessGroupGloo`` over a ``HashStore``)."""
    import torch.distributed as dist

    from qwen_tts_tpu_torch.config import Placement

    group = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    placement = Placement(tp_group=group)
    return dataclasses.replace(cfg, placement=placement, code_predictor=dataclasses.replace(
        cfg.code_predictor, placement=placement))


def test_a_one_rank_group_reduces_and_keeps_the_bits():
    """With a group the trunk reduces whatever the group's size: one rank's
    all-reduces give the group-less decode's bits."""
    from qwen_tts_tpu_torch.generate import generate_codes
    from qwen_tts_tpu_torch.ops.sampling import SamplingConfig
    from qwen_tts_tpu_torch.parallel import comm

    cfg = _port_cfg()
    talker, st = _trees(cfg)
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(0.3 * rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[1, :3] = False
    trailing = torch.from_numpy(0.3 * rng.standard_normal((2, 4, cfg.hidden_size))
                                .astype(np.float32))
    kw = dict(sampling=SamplingConfig(do_sample=True, top_k=8), max_new_tokens=6,
              st_sampling=SamplingConfig(do_sample=True, top_k=8))
    plain = generate_codes(talker, st, cfg, embeds, mask, trailing,
                           generator=torch.Generator().manual_seed(1), **kw)
    before = comm.all_reduce.calls
    grouped = generate_codes(talker, st, _one_rank_cfg(cfg), embeds, mask, trailing,
                             generator=torch.Generator().manual_seed(1), **kw)
    g, layers = cfg.num_code_groups, cfg.code_predictor.num_hidden_layers
    per_frame = 2 * (cfg.num_hidden_layers + g * layers) + g - 1
    # the prefill's 2 a talker layer, then 6 frames (EOS may end rows, not frames)
    assert comm.all_reduce.calls - before == 2 * cfg.num_hidden_layers + 6 * per_frame
    assert torch.equal(plain.codes, grouped.codes)
    assert torch.equal(plain.num_gen, grouped.num_gen)


def test_a_gloo_group_is_not_captured():
    from qwen_tts_tpu_torch import generate
    from qwen_tts_tpu_torch.parallel import comm

    cfg = _port_cfg()
    rank_cfg = _one_rank_cfg(cfg)
    assert comm.capturable(generate.tp_groups(cfg))
    assert not comm.capturable(generate.tp_groups(rank_cfg))
    with pytest.raises(ValueError, match="gloo"):
        generate._FrameGraph(None, None, rank_cfg, None, None, None, None, None, 0)
