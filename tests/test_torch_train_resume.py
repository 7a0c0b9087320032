"""The port's train-state snapshot and resume (``training/checkpoint.py``)
on the CPU: an interrupted run continues with no trace of the interruption
(2 steps + save + restore into fresh state + 2 steps equal 4 straight steps
bit for bit), a snapshot of another architecture refuses to load, and a
snapshot whose ``meta.json`` was never committed leaves the previous one
current."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu_torch.config import tiny_tts_config
from qwen_tts_tpu_torch.models.subtalker import init_subtalker_params
from qwen_tts_tpu_torch.models.talker import init_talker_params
from qwen_tts_tpu_torch.training.checkpoint import load_train_state, save_train_state
from qwen_tts_tpu_torch.training.sft import (
    SFTBatch, make_optimizer, make_train_step, tree_leaves, tree_map)


def _setup(cfg=None):
    cfg = cfg or tiny_tts_config().talker
    gen = torch.Generator().manual_seed(0)
    params = {"talker": init_talker_params(gen, cfg),
              "subtalker": init_subtalker_params(gen, cfg.code_predictor, cfg.hidden_size)}
    return cfg, params, make_optimizer(1e-3)


def _batches(cfg, n, b=2, s=6):
    g = cfg.num_code_groups
    out = []
    for i in range(n):
        r = np.random.default_rng(i)
        out.append(SFTBatch(
            inputs_embeds=torch.tensor(r.standard_normal((b, s, cfg.hidden_size)),
                                       dtype=torch.float32),
            pad_mask=torch.ones((b, s), dtype=torch.bool),
            codec0_labels=torch.tensor(r.integers(0, cfg.vocab_size, (b, s))),
            group_labels=torch.tensor(r.integers(0, cfg.code_predictor.vocab_size, (b, s, g))),
            frame_mask=torch.ones((b, s), dtype=torch.bool),
        ))
    return out


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool else x, y), "bits differ"


def test_resume_is_bit_identical_to_uninterrupted_run(tmp_path):
    cfg, params0, opt = _setup()
    step = make_train_step(cfg, opt)
    batches = _batches(cfg, 4)

    p, o = tree_map(torch.clone, params0), opt.init(params0)
    for bt in batches:
        p, o, loss_a, _ = step(p, o, bt)

    p2, o2 = tree_map(torch.clone, params0), opt.init(params0)
    for bt in batches[:2]:
        p2, o2, _, _ = step(p2, o2, bt)
    ckpt = save_train_state(str(tmp_path / "ck"), p2, o2, step=2, epoch=1, extra={"lr": 1e-3})
    _, fresh, _ = _setup()
    rp, ro, meta = load_train_state(ckpt, fresh, opt)
    assert meta["step"] == 2 and meta["epoch"] == 1 and meta["lr"] == 1e-3
    _same_bits(rp, p2)
    _same_bits(ro, o2)
    for bt in batches[2:]:
        rp, ro, loss_b, _ = step(rp, ro, bt)

    assert float(loss_a) == float(loss_b)
    _same_bits(rp, p)
    _same_bits(ro, o)
    assert int(ro["count"]) == 4


def test_restore_refuses_another_architecture(tmp_path):
    cfg, params, opt = _setup()
    ckpt = save_train_state(str(tmp_path / "ck"), params, opt.init(params), step=1)
    wider = dataclasses.replace(cfg, intermediate_size=2 * cfg.intermediate_size)
    _, other, _ = _setup(wider)
    with pytest.raises(ValueError, match="trunk/gate"):
        load_train_state(ckpt, other, opt)
    # A leaf missing from the fresh state is refused too.
    del params["subtalker"]["norm"]
    with pytest.raises(ValueError, match="subtalker/norm"):
        load_train_state(ckpt, params, opt)
    # And a dtype that differs.
    _, half, _ = _setup()
    half["talker"]["norm"] = half["talker"]["norm"].double()
    with pytest.raises(ValueError, match="talker/norm"):
        load_train_state(ckpt, half, opt)


def test_uncommitted_snapshot_leaves_the_previous_one_current(tmp_path, monkeypatch):
    """A crash before ``meta.json``'s replace: the new snapshot's files are
    on disk, but the restore reads the committed one, and the commit after
    it prunes the leftover."""
    cfg, params, opt = _setup()
    step = make_train_step(cfg, opt)
    d = str(tmp_path / "ck")
    p, o = params, opt.init(params)
    p, o, _, _ = step(p, o, _batches(cfg, 1)[0])
    save_train_state(d, p, o, step=1, epoch=0)
    p, o = tree_map(torch.clone, p), tree_map(torch.clone, o)  # the snapshot's state
    p2, o2, _, _ = step(tree_map(torch.clone, p), tree_map(torch.clone, o),
                        _batches(cfg, 2)[1])

    real_replace = os.replace

    def crash(src, dst):
        if dst.endswith("meta.json"):
            raise OSError("interrupted before the commit")
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError, match="interrupted"):
        save_train_state(d, p2, o2, step=2, epoch=1)
    monkeypatch.setattr(os, "replace", real_replace)
    assert os.path.isdir(os.path.join(d, "state.step2"))
    assert json.load(open(os.path.join(d, "meta.json")))["step"] == 1

    rp, ro, meta = load_train_state(d, _setup()[1], opt)
    assert meta["step"] == 1
    _same_bits(rp, p)
    _same_bits(ro, o)

    save_train_state(d, p2, o2, step=3, epoch=1)
    assert sorted(n for n in os.listdir(d) if n.startswith("state")) == ["state.step3"]
