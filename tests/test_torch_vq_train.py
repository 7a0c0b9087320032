"""The port's EMA VQ trainer (``training/vq.py``) against the JAX package's
on the CPU: where no random draw is made (k-means init off, no dead-code
expiry, no quantize dropout) the train steps give JAX's indices and
buffers; encode and decode give JAX's. The parts that draw random numbers
are held on their semantics, as ``tests/test_vq_train.py`` holds JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.training import vq as jvq
from qwen_tts_tpu_torch.convert import convert_vq_tree
from qwen_tts_tpu_torch.training import vq as tvq

BUFFER_ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cfg_kw):
    jcfg, tcfg = jvq.VQTrainConfig(**cfg_kw), tvq.VQTrainConfig(**cfg_kw)
    key = jax.random.PRNGKey(0)
    j_state = jvq.init_vq_state(jcfg, key)
    j_params = jvq.init_vq_params(jcfg, jax.random.fold_in(key, 1))
    t_state, t_params = convert_vq_tree(_np(j_state), _np(j_params), device="cpu")
    return jcfg, tcfg, j_state, j_params, t_state, t_params


PARITY = {
    "1 group": dict(dim=16, codebook_size=24, num_quantizers=3, num_groups=1),
    "1 group, projection": dict(dim=16, codebook_size=24, codebook_dim=8, num_quantizers=3,
                                num_groups=1),
    "2 groups": dict(dim=16, codebook_size=12, num_quantizers=2, num_groups=2),
    "2 groups, projection": dict(dim=16, codebook_size=12, codebook_dim=4, num_quantizers=2,
                                 num_groups=2),
    "q0 downsampled": dict(dim=8, codebook_size=16, num_quantizers=2, num_groups=1,
                           q0_ds_ratio=2),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_train_steps_match_jax(name):
    kw = dict(PARITY[name], decay=0.9, kmeans_init=False, threshold_ema_dead_code=0.0)
    jcfg, tcfg, j_state, j_params, t_state, t_params = _pair(kw)
    assert tvq.VQState._fields == jvq.VQState._fields
    gen = torch.Generator().manual_seed(0)
    j_step = jax.jit(functools.partial(jvq.vq_train_step, cfg=jcfg))  # one compile, 4 steps
    for step in range(4):
        x = np.random.default_rng(step).standard_normal((3, 10, kw["dim"])).astype(np.float32)
        j_state, j_out = j_step(j_state, j_params, jnp.asarray(x), jax.random.PRNGKey(step))
        t_state, t_out = tvq.vq_train_step(t_state, t_params, torch.from_numpy(x), gen,
                                           cfg=tcfg)
        np.testing.assert_array_equal(t_out.indices.numpy(), np.asarray(j_out.indices))
        np.testing.assert_allclose(t_out.quantized.numpy(), np.asarray(j_out.quantized),
                                   atol=BUFFER_ATOL)
        np.testing.assert_allclose(t_out.loss.numpy(), np.asarray(j_out.loss), atol=BUFFER_ATOL,
                                   rtol=1e-5)
        for field in ("cluster_size", "embed", "embed_avg"):
            np.testing.assert_allclose(getattr(t_state, field).numpy(),
                                       np.asarray(getattr(j_state, field)), atol=BUFFER_ATOL,
                                       rtol=1e-5, err_msg=f"{field} at step {step}")
        np.testing.assert_array_equal(t_state.inited.numpy(), np.asarray(j_state.inited))


@pytest.mark.parametrize("name", ["1 group, projection", "2 groups"])
def test_encode_and_decode_match_jax(name):
    kw = dict(PARITY[name], kmeans_init=False, threshold_ema_dead_code=0.0)
    jcfg, tcfg, j_state, j_params, t_state, t_params = _pair(kw)
    x = np.random.default_rng(9).standard_normal((2, 7, kw["dim"])).astype(np.float32)
    j_idx = jax.jit(functools.partial(jvq.vq_encode, cfg=jcfg))(j_state, j_params,
                                                                jnp.asarray(x))
    t_idx = tvq.vq_encode(t_state, t_params, torch.from_numpy(x), cfg=tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_dec = jax.jit(functools.partial(jvq.vq_decode, cfg=jcfg))(j_state, j_params, j_idx)
    t_dec = tvq.vq_decode(t_state, t_params, t_idx, cfg=tcfg)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), atol=2e-5)
    # Two quantizers or fewer (n_q) encode a prefix of the same codes.
    np.testing.assert_array_equal(
        tvq.vq_encode(t_state, t_params, torch.from_numpy(x), cfg=tcfg, n_q=1).numpy(),
        t_idx[:, :1].numpy())


def test_kmeans_init_seeds_the_codebook_from_the_data():
    """Three tight clusters far apart: ``kmeans`` finds their centres, and
    the first train step seeds the buffers from it (the reference's init:
    ``embed`` and ``embed_avg`` the means, ``cluster_size`` the bins) before
    its EMA update, which then holds each code's count; the buffers are
    marked initialised and a second step does not seed them again."""
    cfg = tvq.VQTrainConfig(dim=4, codebook_size=3, num_quantizers=1, kmeans_init=True,
                            kmeans_iters=10, threshold_ema_dead_code=0.0, decay=0.9)
    r = np.random.default_rng(0)
    centres = np.array([[10, 0, 0, 0], [0, 10, 0, 0], [0, 0, 10, 0]], np.float32)
    x = torch.from_numpy(
        (centres[r.integers(0, 3, 60)] + 0.01 * r.standard_normal((60, 4))).astype(np.float32))
    means, bins = tvq.kmeans(torch.Generator().manual_seed(3), x, 3, 10)
    np.testing.assert_allclose(np.sort(means.numpy(), axis=0), np.sort(centres, axis=0),
                               atol=0.01)
    assert float(bins.sum()) == 60

    state = tvq.init_vq_state(cfg)
    assert not state.inited.any()
    state, out = tvq.vq_train_step(state, None, x.reshape(2, 30, 4),
                                   torch.Generator().manual_seed(3), cfg=cfg)
    assert state.inited.all()
    idx = out.indices[0, 0].reshape(-1)
    counts = torch.bincount(idx, minlength=3).float()
    assert (counts > 0).all()  # each cluster its own code
    np.testing.assert_allclose(state.cluster_size[0, 0].numpy(), counts.numpy(), rtol=1e-6)
    # EMA of the seeded average: 0.9 x mean + 0.1 x the code's sum of rows.
    for c in range(3):
        rows = x[idx == c]
        want = (0.9 * rows.mean(0) + 0.1 * rows.sum(0)).numpy()
        np.testing.assert_allclose(state.embed_avg[0, 0, c].numpy(), want, rtol=1e-4, atol=1e-4)
    state2, _ = tvq.vq_train_step(state, None, x.reshape(2, 30, 4),
                                  torch.Generator().manual_seed(4), cfg=cfg)
    # Not seeded again: a second seeding would give the first step's
    # average once more; the EMA alone moves it on.
    np.testing.assert_allclose(state2.cluster_size[0, 0].numpy(), counts.numpy(), rtol=1e-5)
    assert not torch.allclose(state2.embed_avg, state.embed_avg)


def test_dead_code_expiry_replaces_embeddings():
    cfg = tvq.VQTrainConfig(dim=4, codebook_size=8, num_quantizers=1, num_groups=1,
                            decay=0.9, kmeans_init=False, threshold_ema_dead_code=2.0)
    state = tvq.init_vq_state(cfg, torch.Generator().manual_seed(0))
    # Code 0 is dead: tiny EMA usage and far from the data, so that no point
    # could choose it.
    cs = torch.full((1, 1, cfg.codebook_size), 10.0)
    cs[0, 0, 0] = 1e-4
    emb = state.embed.clone()
    emb[0, 0, 0] = 100.0
    state = state._replace(cluster_size=cs, embed=emb, embed_avg=emb.clone())
    dead_row = emb[0, 0, 0].clone()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 6, 4)).astype(np.float32))
    new_state, out = tvq.vq_train_step(state, None, x, torch.Generator().manual_seed(1), cfg=cfg)
    # Expiry runs before quantizing: the replaced row is a batch row, and
    # this batch already assigns points to it.
    assert (out.indices[0, 0] == 0).any()
    assert float((new_state.embed[0, 0, 0] - dead_row).norm()) > 1.0

    # Without expiry nothing assigns to the far row, and the EMA divides its
    # stale average by ~zero usage: the row blows up.
    cfg0 = tvq.VQTrainConfig(dim=4, codebook_size=8, num_quantizers=1, num_groups=1,
                             decay=0.9, kmeans_init=False, threshold_ema_dead_code=0.0)
    kept, out0 = tvq.vq_train_step(state, None, x, torch.Generator().manual_seed(1), cfg=cfg0)
    assert not (out0.indices[0, 0] == 0).any()
    assert float(kept.embed[0, 0, 0].norm()) > 50.0

    # A codebook whose statistics are all zero is never expired.
    zero = state._replace(cluster_size=torch.zeros_like(cs))
    fresh, _ = tvq.vq_train_step(zero, None, x, torch.Generator().manual_seed(1), cfg=cfg)
    assert float(fresh.embed[0, 0, 0].norm()) > 50.0


def test_quantize_dropout_masks_tail_quantizers():
    cfg = tvq.VQTrainConfig(dim=4, codebook_size=8, num_quantizers=3, num_groups=1,
                            decay=0.9, kmeans_init=False, threshold_ema_dead_code=0.0,
                            quantize_dropout=True, rand_num_quant=(1, 2))
    state = tvq.init_vq_state(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, 4)).astype(np.float32))
    seen = set()
    gen = torch.Generator().manual_seed(5)
    for _ in range(8):
        new_state, out = tvq.vq_train_step(state, None, x, gen, cfg=cfg)
        idx = out.indices[0]  # [Q, B, T]
        n_active = sum(int((idx[q] >= 0).all()) for q in range(3))
        seen.add(n_active)
        assert n_active in (1, 2)
        for q in range(3):
            if q >= n_active:
                assert (idx[q] == -1).all()
                assert torch.equal(new_state.embed[0, q], state.embed[0, q])
                assert torch.equal(new_state.cluster_size[0, q], state.cluster_size[0, q])
                assert float(out.loss[q]) == 0.0
            else:
                assert (idx[q] >= 0).all()
    assert seen == {1, 2}, "both dropout draws should occur"


def test_q0_ds_ratio_mechanics():
    """Quantizer 0 runs at half the time rate and its output is nearest-
    upsampled back: its index track repeats in pairs."""
    cfg = tvq.VQTrainConfig(dim=4, codebook_size=8, num_quantizers=2, num_groups=1,
                            decay=0.9, kmeans_init=False, threshold_ema_dead_code=0.0,
                            q0_ds_ratio=2)
    state = tvq.init_vq_state(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, 4)).astype(np.float32))
    _, out = tvq.vq_train_step(state, None, x, torch.Generator().manual_seed(1), cfg=cfg)
    idx = out.indices[0]
    assert torch.equal(idx[0, :, 0::2], idx[0, :, 1::2])
    assert out.quantized.shape == (2, 8, 4)


def test_a_process_group_waits_for_the_parallelism_slice():
    """The data-parallel step has come (``tests/test_torch_parallel_train.py``
    holds it at dp 4): a one-rank group, which no longer raises, gives the
    group-less step's bits."""
    import torch.distributed as dist

    cfg = tvq.VQTrainConfig(dim=4, codebook_size=8, kmeans_iters=3,
                            threshold_ema_dead_code=2.0)
    group = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 6, 4)).astype(np.float32))
    outs = []
    for g in (None, group):
        state = tvq.init_vq_state(cfg, torch.Generator().manual_seed(0))
        outs.append(tvq.vq_train_step(state, None, x, torch.Generator().manual_seed(3),
                                      cfg=cfg, group=g))
    (s0, o0), (s1, o1) = outs
    for a, b in zip((*s0, *o0), (*s1, *o1)):
        assert torch.equal(a, b)
