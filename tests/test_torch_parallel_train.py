"""Data- and tensor-parallel training of the port on gloo ranks on the CPU:
the SFT step at dp 2 x tp 2 against one device (the loss within 1e-5
relative, the params after each step, a 3-row batch padded with a
loss-neutral row), the tp snapshot against one device's and its restore, the
SFT CLI's ``--dp 2 --tp 2`` (mesh line, step-0 loss; the counterpart of
``tests/test_sft_script_e2e.py``'s mesh test), and the dp 4 VQ step
(``make_sharded_vq_train_step``) against the full batch and against the JAX
package's sharded step (indices exact, buffers within 1e-5, two steps in
lockstep)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_dist import REPO, TESTS, run_ranks
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.config import tiny_tts_config
from qwen_tts_tpu.training import vq as jvq
from qwen_tts_tpu_torch.config import CodePredictorConfig, TalkerConfig
from qwen_tts_tpu_torch.convert import convert_vq_tree
from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile
from qwen_tts_tpu_torch.models import subtalker as t_st
from qwen_tts_tpu_torch.models import talker as t_talker
from qwen_tts_tpu_torch.training import sft_12hz
from qwen_tts_tpu_torch.training import vq as tvq
from qwen_tts_tpu_torch.training.checkpoint import save_train_state
from qwen_tts_tpu_torch.training.sft import SFTBatch, make_optimizer, make_train_step, tree_map

CFG = tiny_tts_config()
# The loss: the same sums in another order (JAX's tolerance,
# tests/test_sft_script_e2e.py:111). The params after a step: AdamW's first
# updates are ~lr x sign(g), so only elements whose gradient sits at the
# noise floor can differ; per leaf in relative L2.
LOSS_RTOL = 1e-5
PARAM_REL_L2 = 1e-5
# VQ buffers: sums over ranks in another order; a code no row chose divides
# its average by a count near epsilon (values ~1e4), so relative as well.
VQ_ATOL = VQ_RTOL = 1e-5
STEPS, LR = 2, 1e-3
VQ_CFG = dict(dim=8, codebook_size=16, codebook_dim=None, num_quantizers=2, num_groups=1,
              decay=0.9, kmeans_iters=4, threshold_ema_dead_code=0.0)


def _port_cfg() -> TalkerConfig:
    d = {f.name: getattr(CFG.talker, f.name) for f in dataclasses.fields(CFG.talker)}
    cp = CFG.talker.code_predictor
    d["code_predictor"] = CodePredictorConfig(
        **{f.name: getattr(cp, f.name) for f in dataclasses.fields(cp)})
    return TalkerConfig(**d)


def _params(cfg):
    g = torch.Generator().manual_seed(3)
    return {"talker": t_talker.init_talker_params(g, cfg),
            "subtalker": t_st.init_subtalker_params(g, cfg.code_predictor, cfg.hidden_size)}


def _batch(cfg, b=3, s=14) -> SFTBatch:
    rng = np.random.default_rng(1)
    pad = np.ones((b, s), bool)
    pad[1, :3] = pad[2, :6] = False
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    labels[~pad] = -100
    labels[:, :4] = -100
    frames = pad & (rng.random((b, s)) < 0.7)
    return SFTBatch(
        inputs_embeds=torch.from_numpy(0.5 * rng.standard_normal((b, s, cfg.hidden_size))
                                       .astype(np.float32)),
        pad_mask=torch.from_numpy(pad), codec0_labels=torch.from_numpy(labels),
        group_labels=torch.from_numpy(rng.integers(
            0, cfg.code_predictor.vocab_size, (b, s, cfg.num_code_groups))),
        frame_mask=torch.from_numpy(frames))


def _vq_runs():
    """(port full-batch, port runs for the ranks, JAX sharded results)."""
    xs = [torch.from_numpy(np.random.default_rng(i).standard_normal((8, 6, 8))
                           .astype(np.float32)) for i in range(2)]
    # k-means init (the port's draws on both sides): dp 4 against the full batch.
    km = tvq.VQTrainConfig(kmeans_init=True, **VQ_CFG)
    state = tvq.init_vq_state(km)
    full = []
    for x, seed in zip(xs, (5, 6)):
        state, out = tvq.vq_train_step(state, None, x, torch.Generator().manual_seed(seed),
                                       cfg=km)
        full.append((state, out))
    # Uniform init carried from JAX (no draw): dp 4 against JAX's sharded step.
    jcfg = jvq.VQTrainConfig(kmeans_init=False, **VQ_CFG)
    j_state = jvq.init_vq_state(jcfg, jax.random.PRNGKey(2))
    t_state, _ = convert_vq_tree(jax.tree_util.tree_map(np.asarray, j_state), None,
                                 device="cpu")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    step = jvq.make_sharded_vq_train_step(mesh, jcfg)
    jax_out = []
    for i, x in enumerate(xs):
        j_state, j_res = step(j_state, None, jax.device_put(jnp.asarray(x.numpy()),
                                                            NamedSharding(mesh, P("dp"))),
                              jax.random.PRNGKey(5 + i))
        jax_out.append((jax.tree_util.tree_map(np.asarray, j_state), np.asarray(j_res.indices)))
    runs = [dict(state=tvq.init_vq_state(km), params=None, xs=xs, seeds=[5, 6], cfg=km),
            dict(state=t_state, params=None, xs=xs, seeds=[5, 6],
                 cfg=tvq.VQTrainConfig(kmeans_init=False, **VQ_CFG))]
    return full, runs, jax_out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One world of 4 ranks: the SFT steps at dp 2 x tp 2 with their
    snapshot, then both VQ runs at dp 4."""
    cfg = _port_cfg()
    work = tmp_path_factory.mktemp("parallel_train")
    full, runs, jax_out = _vq_runs()
    sft = dict(params=_params(cfg), cfg=cfg, batch=_batch(cfg), steps=STEPS, lr=LR,
               workdir=str(work))
    res = run_ranks("torch_dist:train_and_vq", 4, work / "ranks", sft=sft, vq=runs)
    return cfg, work, res, full, jax_out


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def test_sft_dp2_tp2_matches_one_device(ranks):
    cfg, work, res, _, _ = ranks
    params = _params(cfg)
    opt = make_optimizer(LR, weight_decay=0.01)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    ref = []
    for _ in range(STEPS):
        params, state, loss, aux = step(params, state, _batch(cfg))
        ref.append((float(loss), float(aux["talker_ce"]), float(aux["subtalker_ce"])))
    for r, (sft, _) in enumerate(res):
        assert sft["rank_heads"] == (CFG.talker.num_attention_heads // 2,
                                     CFG.talker.num_key_value_heads // 2)
        for got, want in zip(sft["losses"], ref):
            for g, w in zip(got, want):
                assert abs(g - w) <= LOSS_RTOL * max(1.0, abs(w)), (r, got, want)
        flat = tree_map(lambda a, b: _rel_l2(a, b), sft["params"], params)
        worst = max(v for part in flat.values() for v in _values(part))
        assert worst <= PARAM_REL_L2, worst
        assert sft["restored_equal"]
    # The snapshot's files: one device's names, shapes and dtypes.
    save_train_state(str(work / "ref_state"), params, state, step=STEPS)
    for name in ("params", "opt_state"):
        files = [SafeTensorsFile(os.path.join(str(d), f"state.step{STEPS}",
                                              name + ".safetensors"))
                 for d in (work / "state", work / "ref_state")]
        try:
            got, want = files
            assert set(got.keys()) == set(want.keys())
            for k in want.keys():
                a, b = got.get(k), want.get(k)
                assert (a.shape, a.dtype) == (b.shape, b.dtype), k
                if k != "count":
                    assert _rel_l2(a.float(), b.float()) <= PARAM_REL_L2 or name == "opt_state", k
        finally:
            for f in files:
                f.close()


def _values(tree):
    if isinstance(tree, dict):
        return [v for x in tree.values() for v in _values(x)]
    return [tree]


def test_vq_dp4_matches_full_batch_and_jax(ranks):
    _, _, res, full, jax_out = ranks
    fields = ("cluster_size", "embed", "embed_avg")
    for r, (_, (km, uni)) in enumerate(res):
        for (state, idx, loss), (ref_state, ref) in zip(km, full):
            np.testing.assert_array_equal(idx.numpy(), ref.indices[:, :, 2 * r:2 * r + 2].numpy())
            for f in fields:
                np.testing.assert_allclose(getattr(state, f).numpy(),
                                           getattr(ref_state, f).numpy(), atol=VQ_ATOL,
                                           rtol=VQ_RTOL)
            np.testing.assert_allclose(loss.numpy(), ref.loss.numpy(), atol=VQ_ATOL)
        for (state, idx, _), (j_state, j_idx) in zip(uni, jax_out):
            np.testing.assert_array_equal(idx.numpy(), j_idx[:, :, 2 * r:2 * r + 2])
            for f in fields:
                np.testing.assert_allclose(getattr(state, f).numpy(), getattr(j_state, f),
                                           atol=VQ_ATOL, rtol=VQ_RTOL)


def _step0_loss(stdout: str) -> float:
    line = next(l for l in stdout.splitlines() if "step 0 |" in l)
    return float(line.split("loss")[1].split("(")[0])


def test_sft_cli_dp2_tp2(tmp_path):
    base = str(tmp_path / "base")
    cfg = make_checkpoint(base)
    g = cfg.talker.num_code_groups
    rng = np.random.default_rng(0)
    data = str(tmp_path / "train.jsonl")
    with open(data, "w") as f:
        for i in range(3):  # 3 examples at batch 2: the last batch is padded over dp
            f.write(json.dumps({
                "text_ids": [1, 2, 3] + [10 + i, 11, 12 + i],
                "audio_codes": rng.integers(0, cfg.talker.vocab_size // 2, (4 + i, g)).tolist(),
            }) + "\n")
    common = ["--cpu", "--model-path", base, "--data", data, "--speaker-name", "meshvoice",
              "--num-epochs", "1", "--batch-size", "2", "--lr", "1e-4"]
    losses = []
    rc = sft_12hz.train(sft_12hz.parse_args(
        common + ["--output-model-path", str(tmp_path / "solo")]),
        lambda step, batch, loss, aux: losses.append(float(loss)))
    assert rc == 0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]), OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    out = subprocess.run(
        [sys.executable, "-m", "qwen_tts_tpu_torch.training.sft_12hz", *common,
         "--output-model-path", str(tmp_path / "mesh"), "--dp", "2", "--tp", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: dp=2 tp=2 over 4 devices, backend gloo" in out.stdout
    got = _step0_loss(out.stdout)
    assert abs(got - losses[0]) <= 1e-5 * max(1.0, abs(losses[0])), (got, losses[0])
    files = [SafeTensorsFile(str(tmp_path / d / "checkpoint-epoch-0" / "model.safetensors"))
             for d in ("mesh", "solo")]
    try:
        assert {k: (files[0].get(k).shape, files[0].get(k).dtype) for k in files[0].keys()} == {
            k: (files[1].get(k).shape, files[1].get(k).dtype) for k in files[1].keys()}
    finally:
        for f in files:
            f.close()
