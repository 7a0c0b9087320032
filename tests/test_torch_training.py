"""The port's SFT pieces (``training/data.py``, ``training/sft.py``) and its
random initialisers against the JAX package's, on the tiny fixture
checkpoint in f32 on the CPU: the collate layout, the loss and its terms,
every gradient leaf, the optimizer against
``optax.chain(clip_by_global_norm, adamw)``, and whole train steps.

JAX's gradient and train step are jitted once for the file (module-scoped
fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu.models import codec as j_codec
from qwen_tts_tpu.models import speaker as j_speaker
from qwen_tts_tpu.models import subtalker as j_st
from qwen_tts_tpu.models import talker as j_talker
from qwen_tts_tpu.models import trunk as j_trunk
from qwen_tts_tpu.training import data as j_data
from qwen_tts_tpu.training import sft as j_sft
from qwen_tts_tpu_torch.config import tiny_tts_config
from qwen_tts_tpu_torch.convert import convert_encoder_tree
from qwen_tts_tpu_torch.io.loader import load_checkpoint as t_load
from qwen_tts_tpu_torch.models import codec as t_codec
from qwen_tts_tpu_torch.models import speaker as t_speaker
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.models import trunk as t_trunk
from qwen_tts_tpu_torch.training import data as t_data
from qwen_tts_tpu_torch.training import sft as t_sft

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_sft_ckpt"))
    make_checkpoint(d)
    cfg, jt, js, _, _ = j_load(d, talker_dtype=jnp.float32)
    tcfg, tt, ts, _, _ = t_load(d, talker_dtype=torch.float32, device="cpu")
    return cfg, tcfg, {"talker": jt, "subtalker": js}, {"talker": tt, "subtalker": ts}


def examples(cfg, n=2, seed=0):
    """Ragged rows: text 8-9 ids, 6-7 frames, a speaker embedding each."""
    rng = np.random.default_rng(seed)
    return [dict(
        text_ids=np.concatenate([[1, 2, 3], rng.integers(10, 100, 5 + i)]).astype(np.int64),
        audio_codes=rng.integers(0, cfg.talker.code_predictor.vocab_size,
                                 (6 + i, cfg.talker.num_code_groups)).astype(np.int64),
        speaker_embedding=rng.standard_normal(cfg.talker.hidden_size).astype(np.float32),
    ) for i in range(n)]


def batches(setup, seed=0):
    cfg, tcfg, jp, tp = setup
    exs = examples(cfg, seed=seed)
    jb = j_data.collate([j_data.SFTExample(**e) for e in exs], cfg, jp["talker"], jp["subtalker"])
    tb = t_data.collate([t_data.SFTExample(**e) for e in exs], tcfg, tp["talker"],
                        tp["subtalker"])
    return jb, tb


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def flat_pairs(tt, jt, path=""):
    """(path, torch leaf, jax leaf) over a port tree and the JAX tree of the
    same keys."""
    if isinstance(tt, dict):
        assert set(tt) == set(jt), path
        for k in sorted(tt):
            yield from flat_pairs(tt[k], jt[k], f"{path}/{k}")
    elif isinstance(tt, (list, tuple)):
        assert len(tt) == len(jt), path
        for i, (a, b) in enumerate(zip(tt, jt)):
            yield from flat_pairs(a, b, f"{path}/{i}")
    else:
        yield path, tt, jt


@pytest.fixture(scope="module")
def jax_grad(setup):
    cfg = setup[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: j_sft.sft_loss(p, cfg.talker, b), has_aux=True))


@pytest.fixture(scope="module")
def jax_step(setup):
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    return tx, j_sft.make_train_step(setup[0].talker, tx)


def test_collate_matches_jax(setup):
    jb, tb = batches(setup)
    for name in ("pad_mask", "codec0_labels", "group_labels", "frame_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.pad_mask.dtype == tb.frame_mask.dtype == torch.bool
    assert tb.inputs_embeds.dtype == torch.float32
    np.testing.assert_allclose(tb.inputs_embeds.numpy(), np.asarray(jb.inputs_embeds),
                               atol=1e-6, rtol=0)
    assert not tb.inputs_embeds.requires_grad


def test_loss_and_every_gradient_match_jax(setup, jax_grad):
    cfg, tcfg, jp, tp = setup
    jb, tb = batches(setup)
    (j_loss, j_aux), j_grads = jax_grad(jp, jb)
    loss, aux, grads = t_sft.loss_and_grads(tp, tcfg.talker, tb)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for k in ("talker_ce", "subtalker_ce"):
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=LOSS_RTOL, err_msg=k)
    zero = []
    for path, g, jg in flat_pairs(grads, np_tree(j_grads)):
        assert g.shape == jg.shape and g.dtype == torch.float32, path
        assert rel_l2(g.numpy(), jg) <= GRAD_REL_L2, (path, rel_l2(g.numpy(), jg))
        if not jg.any():
            zero.append(path)
    # collate builds the inputs outside the loss: the text track's weights
    # get zero gradients in both packages.
    assert {"/talker/text_embedding", "/talker/text_proj_fc1"} <= set(zero)


def test_remat_gives_the_same_loss_and_gradients(setup):
    _, tcfg, _, tp = setup
    _, tb = batches(setup, seed=1)
    plain = t_sft.loss_and_grads(tp, tcfg.talker, tb, remat=False)
    remat = t_sft.loss_and_grads(tp, tcfg.talker, tb, remat=True)
    assert float(plain[0]) == float(remat[0])
    for g, r in zip(t_sft.tree_leaves(plain[2]), t_sft.tree_leaves(remat[2])):
        np.testing.assert_allclose(r.numpy(), g.numpy(), rtol=1e-6, atol=1e-9)


def test_optimizer_matches_optax_on_the_same_gradients(monkeypatch):
    """Three steps of the same gradients: the second is clipped (its norm
    far above the clip), leaf "z" always has a zero gradient (it still
    decays, and its moments stay zero), and weight decay is not optax's
    default 1e-4 on one of the two runs."""
    r = np.random.default_rng(0)
    params = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": [r.standard_normal(5).astype(np.float32)],
              "z": r.standard_normal((2, 2)).astype(np.float32)}
    grads = []
    for scale in (0.1, 50.0, 0.3):
        g = {"a": scale * r.standard_normal((4, 3)).astype(np.float32),
             "b": [scale * r.standard_normal(5).astype(np.float32)],
             "z": np.zeros((2, 2), np.float32)}
        grads.append(g)
    norms = [np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree_util.tree_leaves(g)))
             for g in grads]
    assert norms[0] < 1.0 < norms[1]

    for wd in (1e-4, 0.01):
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2, weight_decay=wd))
        opt = t_sft.make_optimizer(1e-2, weight_decay=wd, grad_clip=1.0)
        jp, js = params, tx.init(params)
        tp = jax.tree_util.tree_map(torch.tensor, params)
        ts = opt.init(tp)
        for g in grads:
            updates, js = tx.update(g, js, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step(jax.tree_util.tree_map(torch.tensor, g), ts, tp)
            for path, t, j in flat_pairs(tp, np_tree(jp)):
                np.testing.assert_allclose(t.numpy(), j, atol=PARAM_ATOL, rtol=0, err_msg=path)
        assert int(ts["count"]) == 3
        assert not ts["mu"]["z"].any() and not ts["nu"]["z"].any()
        # The zero-gradient leaf decayed: p * (1 - lr * wd) a step.
        np.testing.assert_allclose(tp["z"].numpy(), params["z"] * (1 - 1e-2 * wd) ** 3,
                                   rtol=1e-6)
        for path, t, j in flat_pairs(ts["mu"], np_tree(js[1][0].mu)):
            np.testing.assert_allclose(t.numpy(), j, atol=1e-7, rtol=1e-6, err_msg=path)

    # Leaves updated in pieces (as large leaves are) give the same bits.
    tp = jax.tree_util.tree_map(torch.tensor, params)
    pieces = jax.tree_util.tree_map(torch.tensor, params)
    ts, ps = opt.init(tp), opt.init(pieces)
    monkeypatch.setattr(t_sft, "_PIECE", 5)
    for g in grads:
        tg = jax.tree_util.tree_map(torch.tensor, g)
        monkeypatch.setattr(t_sft, "_PIECE", 1 << 24)
        opt.step(tg, ts, tp)
        monkeypatch.setattr(t_sft, "_PIECE", 5)
        opt.step(tg, ps, pieces)
    for a, b in zip(t_sft.tree_leaves((tp, ts)), t_sft.tree_leaves((pieces, ps))):
        assert torch.equal(a, b)


def test_train_steps_match_jax_and_the_loss_falls(setup, jax_step):
    cfg, tcfg, jp, tp = setup
    tx, j_step = jax_step
    jb, tb = batches(setup)
    opt = t_sft.make_optimizer(1e-3)
    t_step = t_sft.make_train_step(tcfg.talker, opt)
    j_params, j_state = jp, tx.init(jp)
    start = t_sft.tree_map(torch.clone, tp)
    t_params, t_state = start, opt.init(tp)
    losses = []
    for _ in range(3):
        j_params, j_state, j_loss, _ = j_step(j_params, j_state, jb)
        t_params, t_state, t_loss, aux = t_step(t_params, t_state, tb)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
        losses.append(float(t_loss))
    assert losses[2] < losses[0]
    # adamw's rsqrt of the second moment magnifies the gradients' float
    # reassociation over the steps; JAX's own remat test allows the same.
    for path, t, j in flat_pairs(t_params, np_tree(j_params)):
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-3, atol=1e-5, err_msg=path)
    # The step updated the trees in place and returned them; the fixture's
    # params, cloned, are as they were.
    assert t_params is start and int(t_state["count"]) == 3
    np.testing.assert_array_equal(tp["talker"]["norm"].numpy(),
                                  np.asarray(jp["talker"]["norm"]))


# --------------------------------------------------------------------------
# Initialisers


def _fan(init: str, path: str, shape) -> int:
    """fan_in of a random leaf as the JAX initialisers divide by it."""
    key = path.rsplit("/", 1)[-1]
    if init == "speaker":  # the port's layout: convs [C_out, C_in, K], linears [in, out]
        return shape[1] * shape[2] if len(shape) == 3 else shape[0]
    if key in ("codec_embedding", "text_embedding", "embeds", "codebooks"):
        return shape[-1]
    if init == "codec" and len(shape) == 3 and "/trunk/" not in path:
        taps_in = shape[0] * shape[1]  # [K, C_in, C_out]
        return taps_in // 2 if path.startswith("/blocks/") and key == "tconv_w" else taps_in
    if init == "codec" and len(shape) == 2 and key.endswith("_w"):
        return shape[0]
    return shape[-2]  # [..., in, out]


def _init_pair(init: str):
    """(the JAX tree, the port's initialiser on a generator) for ``init``;
    each JAX initialiser runs jitted, one compile instead of one a leaf."""
    cfg = tiny_tts_config()
    tk, cp, dec, se = cfg.talker, cfg.talker.code_predictor, cfg.codec.decoder, cfg.speaker_encoder
    pairs = {
        "trunk": (lambda k: j_trunk.init_trunk_params(k, j_talker.talker_dims(tk)),
                  lambda g: t_trunk.init_trunk_params(g, t_talker.talker_dims(tk))),
        "talker": (lambda k: j_talker.init_talker_params(k, tk),
                   lambda g: t_talker.init_talker_params(g, tk)),
        "subtalker": (lambda k: j_st.init_subtalker_params(k, cp, tk.hidden_size),
                      lambda g: t_st.init_subtalker_params(g, cp, tk.hidden_size)),
        "subtalker_proj": (lambda k: j_st.init_subtalker_params(k, cp, 2 * tk.hidden_size),
                           lambda g: t_st.init_subtalker_params(g, cp, 2 * tk.hidden_size)),
        "codec": (lambda k: j_codec.init_codec_params(k, dec),
                  lambda g: t_codec.init_codec_params(g, dec)),
        "speaker": (lambda k: j_speaker.init_speaker_params(k, se),
                    lambda g: t_speaker.init_speaker_params(g, se)),
    }
    j_init, t_init = pairs[init]
    j_tree = np_tree(jax.jit(j_init)(jax.random.PRNGKey(0)))
    if init == "speaker":  # to the port's conv layout
        j_tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                        convert_encoder_tree(j_tree, device="cpu"))
    return j_tree, t_init


@pytest.mark.parametrize("init", ["trunk", "talker", "subtalker", "subtalker_proj", "codec",
                                  "speaker"])
def test_initialisers_give_jax_trees_and_distributions(init):
    """The JAX package's keys, nesting, shapes and dtypes (the speaker
    encoder in the port's conv layout); constant leaves (norms, biases,
    SnakeBeta, LayerScale) equal, random ones with std within 10% of
    1/sqrt(fan_in) and mean near 0."""
    j_tree, t_init = _init_pair(init)
    t_tree = t_init(torch.Generator().manual_seed(1))
    for path, t, j in flat_pairs(t_tree, j_tree):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32 and j.dtype == np.float32, path
        if j.std() == 0:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
            continue
        want = 1 / np.sqrt(_fan(init, path, j.shape))
        got = float(t.std())
        assert abs(got / want - 1) < 0.1, (path, got, want)
        assert abs(float(t.mean())) < 4 * want / np.sqrt(t.numel()), path
