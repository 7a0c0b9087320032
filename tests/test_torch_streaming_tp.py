"""Streaming on a tensor-parallel placement (``qwen_tts_tpu_torch/
pipeline.py``), f32 on the CPU, on the shared clone checkpoint.

A greedy B=1 ``stream_custom_voice`` at tp 2 over gloo, both ranks
streaming (``tests/torch_dist.py``), through the first packet, a later
25-frame-style segment and the later codec windows: the frames equal the JAX
package's unsharded stream's and each chunk's waveform its chunk's within
``F32_ATOL`` (the chunking of tests/test_torch_streaming.py).

The first packet's route on the card, rehearsed on the CPU: with
``graphs.Graph`` replaced by a stand-in that runs its function, a prompt
that claims to be on the card takes ``_FirstPacketGraph`` with no tp group
and ``_first_packet_eager`` under a gloo group (``comm.capturable``), and
never reaches ``_FirstPacketGraph`` there. Both routes give the eager codes
and waveform.

Alone ~36 s on the CPU; ~21 s of worker time inside the tier-1 run
(6 xdist workers)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from test_torch_streaming import CHUNKING, F32_ATOL, IDS, MAX_NEW, _params, _prompt, _stream
from torch_dist import run_ranks
from torch_port_fixtures import clone_checkpoint, one_torch_thread, serving_models  # noqa: F401
from qwen_tts_tpu_torch import generate as t_generate
from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.config import Placement


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return serving_models(clone_checkpoint(tmp_path_factory))


def test_tp_stream_equals_jax_unsharded(models, tmp_path, monkeypatch):
    jm, tm = models
    kwargs = dict(CHUNKING, max_new_tokens=MAX_NEW, do_sample=False, subtalker_dosample=False,
                  repetition_penalty=1.0, min_new_tokens=MAX_NEW + 1)
    t0 = time.monotonic()
    ranks = run_ranks("torch_dist:tp_stream", 2, tmp_path, cfg=tm.cfg, talker=tm.talker_params,
                      subtalker=tm.subtalker_params, codec=tm.codec_params, ids=IDS,
                      speaker="serena", language="english", kwargs=kwargs)
    print(f"tp stream ranks: {time.monotonic() - t0:.1f} s")
    j_chunks, j_frames = _stream(jm, monkeypatch)
    up = tm.cfg.codec.decode_upsample_rate
    heads = tm.cfg.talker.num_attention_heads, tm.cfg.talker.num_key_value_heads
    for r in ranks:
        assert r["heads"] == (heads[0] // 2, heads[1] // 2)  # each rank holds half
        # 8 frames emitted (the 9th, budget-exhausted, is dropped): 2 + 4 + 2.
        assert [c.shape[0] for c in r["chunks"]] == [2 * up, 4 * up, 2 * up]
        np.testing.assert_array_equal(r["frames"], j_frames)
        for t, j in zip(r["chunks"], j_chunks):
            np.testing.assert_allclose(t, np.asarray(j), atol=F32_ATOL, rtol=0)
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0]["chunks"], ranks[1]["chunks"]))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (the route's test)."""

    @property
    def is_cuda(self):
        return True


class _CallingGraph:
    """``graphs.Graph`` on the CPU: runs the function where a capture and a
    replay would."""

    def __init__(self, fn, generator=None):
        self.fn, self.generator, self.outputs = fn, generator, None

    def replay(self):
        self.outputs = self.fn()

    drawing_from = graphs.Graph.drawing_from


def _one_rank_gloo(cfg):
    group = torch.distributed.ProcessGroupGloo(torch.distributed.HashStore(), 0, 1)
    placement = Placement(tp_group=group)
    return dataclasses.replace(cfg, placement=placement, code_predictor=dataclasses.replace(
        cfg.code_predictor, placement=placement))


@pytest.mark.parametrize("group", ["none", "gloo"])
def test_first_packet_route_follows_capturable(models, monkeypatch, group):
    _, tm = models
    talker_cfg = tm.cfg.talker if group == "none" else _one_rank_gloo(tm.cfg.talker)
    built, eager_checks = [], []
    real_eager, real_graph = t_pipeline._first_packet_eager, t_pipeline._FirstPacketGraph

    def eager(*args, check=True, **kw):
        eager_checks.append(check)
        plain = [a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) else a
                 for a in args]
        return real_eager(*plain, check=check, **kw)

    def graph(*args, **kw):
        built.append(args[3])
        return real_graph(*args, **kw)

    monkeypatch.setattr(graphs, "Graph", _CallingGraph)
    monkeypatch.setattr(t_pipeline, "_first_packet_eager", eager)
    monkeypatch.setattr(t_pipeline, "_FirstPacketGraph", graph)
    p = _params(tm)
    embeds, mask, trailing, _ = t_generate.batch_prompts([_prompt(tm)], bucket=16)
    kw = dict(sampling=p.talker_sampling(), st_sampling=p.subtalker_sampling(),
              max_cache_len=embeds.shape[1] + MAX_NEW, first_segment=2, step_limit=MAX_NEW)
    graphs.clear()
    try:
        state, seg, wav = t_pipeline._first_packet_program(
            tm.talker_params, tm.subtalker_params, tm.codec_params, talker_cfg,
            tm.cfg.codec.decoder, embeds.as_subclass(_OnCard), mask, trailing,
            generator=None, **kw)
    finally:
        graphs.clear()
    if group == "none":
        assert built == [talker_cfg] and eager_checks == [False]  # run inside the graph
    else:
        assert built == [] and eager_checks == [True]  # eager, its flag read as eager work
    want = real_eager(tm.talker_params, tm.subtalker_params, tm.codec_params, tm.cfg.talker,
                      tm.cfg.codec.decoder, embeds, mask, trailing, generator=None, **kw)
    torch.testing.assert_close(seg.as_subclass(torch.Tensor), want[1], rtol=0, atol=0)
    torch.testing.assert_close(wav.as_subclass(torch.Tensor), want[2], rtol=0, atol=0)
    assert int(state.num_gen[0]) == int(want[0].num_gen[0]) == 2
