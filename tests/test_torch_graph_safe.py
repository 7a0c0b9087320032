"""What the card captures as CUDA graphs reads no device value on the host.

One frame of ``_frame_body`` (with the copy-back ``_FrameGraph`` adds) and
the first-packet program as it is captured (``_first_packet_eager`` with
``check=False``, more frames than one flag-read period) run on the CPU on
the tiny fixture under a dispatch mode that fails on every op that hands a
device value to the host. Each mode of the port: f32 and bf16 talker, int8
weights (``quantize_for_serving(talker=True)``) and int8 weights + int8 KV
cache, greedy and sampled from a generator (top-k, top-p, repetition
penalty, min_new_tokens)."""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu_torch import generate as t_gen
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.generate import GenerationParams
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

aten = torch.ops.aten
HOST_READS = {aten._local_scalar_dense, aten.nonzero, aten.is_nonzero, aten.equal, aten.item}
IDS = [1, 2, 3, 10, 11, 12, 13, 4, 5, 1, 2, 3]
MODES = [(torch.float32, "float"), (torch.bfloat16, "float"), (torch.float32, "int8"),
         (torch.float32, "int8+kv"), (torch.bfloat16, "int8+kv")]


class NoHostReads(TorchDispatchMode):
    """Fails on any op that needs the host to read a device value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            raise AssertionError(f"host read of a device value: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_host_reads():
    x = torch.arange(4)
    with NoHostReads():
        for read in (lambda: int(x[1]), lambda: bool(x.any()), lambda: x.nonzero(),
                     lambda: torch.equal(x, x), lambda: x[1].item()):
            with pytest.raises(AssertionError, match="host read"):
                read()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_graph_safe_ckpt"))
    make_checkpoint(d)
    return d


@pytest.fixture(scope="module")
def model_of(ckpt):
    """(dtype, mode) -> the model, each loaded once."""
    models = {}

    def get(dtype, mode):
        if (dtype, mode) not in models:
            model = Qwen3TTSModel.from_pretrained(ckpt, talker_dtype=dtype, device="cpu",
                                                  load_tokenizer=False)
            if mode != "float":
                model.quantize_for_serving(talker=True, kv=mode == "int8+kv")
            models[dtype, mode] = model
        return models[dtype, mode]

    return get


def _params(sampled: bool) -> GenerationParams:
    gp = GenerationParams(max_new_tokens=16, top_k=20, top_p=0.8, repetition_penalty=1.1,
                          min_new_tokens=3)
    return gp if sampled else gp.greedy()


def _inputs(model):
    dtype = model.talker_params["norm"].dtype
    p = t_gen.build_prompt(model.talker_params, model.cfg, IDS, language="english",
                           speaker="aiden")
    e, m, t, _ = t_gen.batch_prompts([p, p._replace(embeds=p.embeds[2:])], bucket=8)
    return e.to(dtype), m, t.to(dtype)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("dtype,mode", MODES)
def test_a_frame_reads_no_device_value(model_of, dtype, mode, sampled):
    model = model_of(dtype, mode)
    gp = _params(sampled)
    e, m, t = _inputs(model)
    generator = torch.Generator().manual_seed(0)
    state = t_gen._prefill(model.talker_params, model.cfg.talker, e, m,
                           sampling=gp.talker_sampling(), max_cache_len=e.shape[1] + 16,
                           generator=generator, kv_int8=model.kv_int8)
    limit = torch.tensor([16, 5], dtype=torch.int32)
    body = t_gen._frame_body(model.talker_params, model.subtalker_params, model.cfg.talker,
                             gp.talker_sampling(), gp.subtalker_sampling(), t, limit, generator)
    with NoHostReads():
        for _ in range(2):
            new, codes = body(state)
            for f in ("token", "hidden", "eos", "num_gen"):
                getattr(state, f).copy_(getattr(new, f))
            more = t_gen._any_active(new, limit)
    assert codes.shape == (2, model.cfg.talker.num_code_groups) and bool(more)
    assert state.num_gen.tolist() == [2, 2]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("dtype,mode", MODES)
def test_the_first_packet_program_reads_no_device_value(model_of, dtype, mode, sampled):
    model = model_of(dtype, mode)
    gp = _params(sampled)
    e, m, t = _inputs(model)
    frames = t_gen.CHECK_EVERY + 2
    with NoHostReads():
        state, seg, wav = t_pipeline._first_packet_eager(
            model.talker_params, model.subtalker_params, model.codec_params, model.cfg.talker,
            model.cfg.codec.decoder, e, m, t, sampling=gp.talker_sampling(),
            st_sampling=gp.subtalker_sampling(), max_cache_len=e.shape[1] + 16,
            generator=torch.Generator().manual_seed(0), first_segment=frames, step_limit=16,
            kv_int8=model.kv_int8, check=False)
    assert seg.shape == (2, frames, model.cfg.talker.num_code_groups)
    assert wav.shape == (2, frames * model.cfg.codec.decode_upsample_rate)
    assert torch.isfinite(wav).all()
    assert dataclasses.is_dataclass(state) and int(state.num_gen.max()) <= frames
