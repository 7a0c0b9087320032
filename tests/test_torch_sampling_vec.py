"""Per-row sampling (``qwen_tts_tpu_torch/ops/sampling_vec.py``) against the
JAX package's ``ops/sampling_vec.py`` and the port's own static sampler.

Greedy rows are the argmax and agree with the JAX function exactly. Rows
that all hold one static config draw ``sample_token``'s tokens bit for bit
from the same generator state (the two differ in no op on such rows). The
masks are checked exactly: top-k keeps every logit at or above the k-th,
ties included, and top-p runs after it, over the top-k-filtered
distribution. Sampled draws cannot match ``jax.random``; they are held to
the kept sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.ops import sampling_vec as j_vec
from qwen_tts_tpu.ops.sampling import SamplingConfig as JaxSamplingConfig
from qwen_tts_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplingConfig,
    _top_k_filter,
    _top_p_filter,
    sample_token,
)
from qwen_tts_tpu_torch.ops.sampling_vec import (
    VecSampling,
    apply_repetition_penalty_vec,
    sample_token_vec,
    warp_vec,
)

V = 64
CONFIGS = {
    "plain": SamplingConfig(temperature=0.9, top_k=0, top_p=1.0),
    "top_k": SamplingConfig(temperature=0.7, top_k=5, top_p=1.0),
    "top_p": SamplingConfig(temperature=1.3, top_k=0, top_p=0.6),
    "both": SamplingConfig(temperature=0.9, top_k=20, top_p=0.8),
    "cold": SamplingConfig(temperature=1e-7, top_k=50, top_p=0.95),
}


def _logits(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, V)).astype(np.float32)
                            * 3)


def _jax_vec(vs: VecSampling):
    return j_vec.VecSampling(**{f: jnp.asarray(getattr(vs, f).numpy())
                                for f in j_vec.VecSampling._fields})


def test_greedy_rows_equal_the_jax_argmax():
    logits = _logits(6)
    vs = VecSampling.broadcast(SamplingConfig(do_sample=False), 6)
    vs.set_row(2, SamplingConfig(do_sample=False, temperature=0.3, top_k=3, top_p=0.5))
    got = sample_token_vec(logits, vs, torch.Generator().manual_seed(0))
    want = j_vec.sample_token_vec(jnp.asarray(logits.numpy()), _jax_vec(vs),
                                  jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1).numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_uniform_rows_draw_sample_tokens_bits(name):
    """Every row at one static config: the tokens of ``sample_token`` from
    the same generator state, over many draws."""
    cfg = CONFIGS[name]
    vs = VecSampling.broadcast(cfg, 8)
    for seed in range(20):
        logits = _logits(8, seed)
        got = sample_token_vec(logits, vs, torch.Generator().manual_seed(seed))
        want = sample_token(logits, cfg, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), (name, seed)


def test_mixed_rows_each_draw_as_its_own_config():
    """A pool of rows with different controls: each sampled row's token lies
    in its own kept set, each greedy row is its argmax."""
    names = sorted(CONFIGS)
    vs = VecSampling.broadcast(SamplingConfig(), len(names) + 1)
    for i, name in enumerate(names):
        vs.set_row(i, CONFIGS[name])
    vs.set_row(len(names), SamplingConfig(do_sample=False))
    for seed in range(30):
        logits = _logits(len(names) + 1, seed)
        tokens = sample_token_vec(logits, vs, torch.Generator().manual_seed(seed))
        for i, name in enumerate(names):
            cfg = CONFIGS[name]
            kept = _top_p_filter(_top_k_filter(logits[i:i + 1] / max(cfg.temperature, 1e-5),
                                               cfg.top_k), cfg.top_p)[0] > NEG_INF / 2
            assert kept[tokens[i]], (name, seed)
        assert tokens[-1] == logits[-1].argmax()


def test_top_k_keeps_the_kth_and_its_ties():
    row = torch.tensor([[5.0, 4.0, 3.0, 3.0, 3.0, 1.0, 0.0, -1.0]])
    for k, want in ((1, 1), (2, 2), (3, 5), (4, 5), (5, 5), (6, 6), (0, 8), (8, 8), (9, 8)):
        vs = VecSampling.broadcast(SamplingConfig(temperature=1.0, top_k=k, top_p=1.0), 1)
        kept = warp_vec(row, vs)[0] > NEG_INF / 2
        assert int(kept.sum()) == want, k
        assert torch.equal(kept, _top_k_filter(row, k)[0] > NEG_INF / 2), k


def test_top_p_runs_after_top_k():
    """top_p over the top-k-filtered distribution: with top_k 2 the two
    kept logits share all the mass (0.525 and 0.475), so top_p 0.5 keeps
    one; over the whole row it keeps three."""
    row = torch.tensor([[2.0, 1.9, 1.8, 1.7, 1.6, 1.5, -3.0, -4.0]])
    vs = VecSampling.broadcast(SamplingConfig(temperature=1.0, top_k=2, top_p=0.5), 1)
    kept = warp_vec(row, vs)[0] > NEG_INF / 2
    assert kept.tolist() == [True] + [False] * 7
    alone = _top_p_filter(row, 0.5)[0] > NEG_INF / 2
    assert int(alone.sum()) > 1
    for seed in range(5):
        logits = _logits(4, seed)
        for cfg in CONFIGS.values():
            vs = VecSampling.broadcast(cfg, 4)
            warped = logits / max(cfg.temperature, 1e-5)
            assert torch.equal(warp_vec(logits, vs),
                               _top_p_filter(_top_k_filter(warped, cfg.top_k), cfg.top_p))


def test_repetition_penalty_vec_matches_jax():
    logits = _logits(4, 3)
    presence = torch.from_numpy(np.random.default_rng(4).random((4, V)) < 0.3)
    penalty = torch.tensor([1.0, 1.05, 1.3, 0.9])
    got = apply_repetition_penalty_vec(logits, presence, penalty)
    want = j_vec.apply_repetition_penalty_vec(jnp.asarray(logits.numpy()),
                                              jnp.asarray(presence.numpy()),
                                              jnp.asarray(penalty.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vec_sampling_rows_like_jax():
    cfg = SamplingConfig(do_sample=True, temperature=0.5, top_k=7, top_p=0.9,
                         repetition_penalty=1.2, min_new_tokens=3)
    jcfg = JaxSamplingConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    got = VecSampling.broadcast(SamplingConfig(), 3).set_row(1, cfg)
    want = j_vec.VecSampling.broadcast(JaxSamplingConfig(), 3).set_row(1, jcfg)
    for f in j_vec.VecSampling._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    row = VecSampling.host_row(cfg)
    assert row.top_k.shape == (1,) and row.top_k.device.type == "cpu"
    assert row.temperature.dtype == torch.float32 and row.min_new_tokens.dtype == torch.int32
