"""Tensor- and data-parallel inference of the port (``parallel/mesh.py``,
the trunk's collectives) on gloo ranks on the CPU, held against the JAX
package's unsharded ``generate_codes`` on ``tiny_tts_config()`` with the
parameters carried across, as ``tests/test_tp_inference.py`` builds them:
greedy codes at tp 2, dp 2 x tp 2 and tp 4 (whose KV heads do not divide:
``wk`` / ``wv`` whole, each rank caching the heads its q heads map to) equal
JAX's and are equal on every rank; a sampled dp decode equals the port's
unsharded sampled decode (every dp rank draws the global batch's noise and
keeps its rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import run_ranks
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.config import tiny_tts_config
from qwen_tts_tpu.generate import GenerationParams, batch_prompts, build_prompt, generate_codes
from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import talker as j_talker
from qwen_tts_tpu_torch.config import TalkerConfig
from qwen_tts_tpu_torch.convert import convert_params
from qwen_tts_tpu_torch.generate import generate_codes as t_generate_codes
from qwen_tts_tpu_torch.ops.sampling import SamplingConfig

CFG = tiny_tts_config()
FRAMES = 10
SEED = 11


def _port_cfg() -> TalkerConfig:
    """The port's TalkerConfig of the tiny JAX config (shard_params writes
    the rank's heads into a copy)."""
    import dataclasses

    from qwen_tts_tpu_torch.config import CodePredictorConfig

    d = {f.name: getattr(CFG.talker, f.name) for f in dataclasses.fields(CFG.talker)}
    cp = CFG.talker.code_predictor
    d["code_predictor"] = CodePredictorConfig(
        **{f.name: getattr(cp, f.name) for f in dataclasses.fields(cp)})
    return TalkerConfig(**d)


@pytest.fixture(scope="module")
def setup():
    rng = jax.random.PRNGKey(7)
    jt = j_talker.init_talker_params(rng, CFG.talker)
    js = j_st.init_subtalker_params(jax.random.fold_in(rng, 1), CFG.talker.code_predictor,
                                    CFG.talker.hidden_size)
    base = np.array([1, 2, 3, 10, 11, 12, 4, 5, 1, 2, 3], np.int32)
    prompts = [build_prompt(jt, CFG, base + i, language="english", speaker="aiden")
               for i in range(4)]
    embeds, mask, trailing, _ = batch_prompts(prompts)
    gp = GenerationParams(max_new_tokens=FRAMES, min_new_tokens=FRAMES, do_sample=False,
                          subtalker_do_sample=False, repetition_penalty=1.0)
    out = generate_codes(jt, js, CFG.talker, jnp.asarray(embeds), jnp.asarray(mask),
                         jnp.asarray(trailing), sampling=gp.talker_sampling(),
                         st_sampling=gp.subtalker_sampling(), max_new_tokens=FRAMES,
                         rng=jax.random.PRNGKey(0))
    tt, ts, _ = convert_params(*jax.tree_util.tree_map(np.asarray, (jt, js)),
                               talker_dtype=torch.float32, device="cpu")
    inputs = tuple(torch.from_numpy(np.asarray(x)) for x in (embeds, mask, trailing))
    return tt, ts, _port_cfg(), inputs, (np.asarray(out.codes), np.asarray(out.num_gen))


def _port_codes(setup, sample: bool):
    tt, ts, cfg, inputs, _ = setup
    talker_s = SamplingConfig(do_sample=sample, top_k=8, temperature=0.9,
                              repetition_penalty=1.05 if sample else 1.0, min_new_tokens=FRAMES)
    st_s = SamplingConfig(do_sample=sample, top_k=8, temperature=0.9)
    res = t_generate_codes(tt, ts, cfg, *inputs, sampling=talker_s, st_sampling=st_s,
                           max_new_tokens=FRAMES, generator=torch.Generator().manual_seed(SEED))
    return res.codes.numpy(), res.num_gen.numpy()


def _rows(results, key):
    return (np.concatenate([r[key][0].numpy() for r in results]),
            np.concatenate([r[key][1].numpy() for r in results]))


def _run(setup, tmp_path, world, meshes):
    tt, ts, cfg, inputs, _ = setup
    return run_ranks("torch_dist:decode", world, tmp_path, talker=tt, subtalker=ts, cfg=cfg,
                     embeds=inputs[0], mask=inputs[1], trailing=inputs[2], meshes=meshes,
                     max_new=FRAMES, seed=SEED)


def test_unsharded_port_matches_jax(setup):
    codes, num = _port_codes(setup, sample=False)
    np.testing.assert_array_equal(num, setup[4][1])
    np.testing.assert_array_equal(codes, setup[4][0])


def test_tp2_and_dp2_greedy_and_sampled(setup, tmp_path):
    """World 2: tp 2 (every rank the whole batch) and dp 2 (each rank half
    the rows), greedy and sampled."""
    j_codes, j_num = setup[4]
    res = _run(setup, tmp_path, 2, [(2, False), (1, False), (1, True)])
    for r in res:  # tp 2: every rank decodes the whole batch, equal to JAX
        codes, num, calls, kv = r[(2, False)]
        np.testing.assert_array_equal(num.numpy(), j_num)
        np.testing.assert_array_equal(codes.numpy(), j_codes)
        assert kv == CFG.talker.num_key_value_heads // 2
        assert calls > 0
    codes, num = _rows(res, (1, False))
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_array_equal(num, j_num)
    s_codes, s_num = _port_codes(setup, sample=True)
    codes, num = _rows(res, (1, True))
    assert not np.array_equal(s_codes, j_codes)  # the draws mattered
    np.testing.assert_array_equal(codes, s_codes)
    np.testing.assert_array_equal(num, s_num)


def test_dp2_tp2_and_tp4_greedy(setup, tmp_path):
    """World 4: dp 2 x tp 2 (greedy and sampled) and tp 4, whose 2 KV heads
    do not divide: each rank keeps the head its one q head maps to."""
    j_codes, j_num = setup[4]
    res = _run(setup, tmp_path, 4, [(2, False), (2, True), (4, False)])
    for key, want in (((2, False), (j_codes, j_num)),
                      ((2, True), _port_codes(setup, sample=True))):
        # Ranks (dp, tp) = (0, 0), (0, 1), (1, 0), (1, 1): a tp pair holds
        # one dp shard's rows, equal on both of its ranks.
        for a, b in ((0, 1), (2, 3)):
            assert torch.equal(res[a][key][0], res[b][key][0])
        codes, num = _rows([res[0], res[2]], key)
        np.testing.assert_array_equal(codes, want[0])
        np.testing.assert_array_equal(num, want[1])
    for r in res:
        codes, num, _, kv = r[(4, False)]
        assert kv == 1
        np.testing.assert_array_equal(codes.numpy(), j_codes)
        np.testing.assert_array_equal(num.numpy(), j_num)
