"""The decode loop that the card replays frame by frame, run eagerly on the
CPU: frames in chunks of ``CHECK_EVERY`` with one read of the "any row
active" flag between chunks, and frames past the point where every row is
done changing nothing.

Tiny fixture, f32, greedy, EOS allowed: the talker's EOS column is set to
1.01 x the column of a token that the rows first choose at different frames
(the same change in both packages), so rows stop at different frames, and
one row's budget (``step_limit``) is shorter still. Codes, ``num_gen`` and
the EOS flags must equal the JAX package's exactly (float, int8 weights,
int8 weights + int8 KV cache), whole requests and streamed segments; the
segment buffer and the state must equal, bit for bit, those of the loop
that reads the flag before every frame and stops at once. The graph
runners' bookkeeping runs here too, with the capture replaced by calls."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu import generate as j_gen
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JaxModel
from qwen_tts_tpu_torch import generate as t_gen
from qwen_tts_tpu_torch import graphs
from qwen_tts_tpu_torch import pipeline as t_pipeline
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TorchModel

ROLE, TAIL = [1, 2, 3], [4, 5, 1, 2, 3]
CONTENTS = [list(range(10, 14)), list(range(20, 27)), list(range(30, 33)), list(range(40, 50))]
SPEAKERS = ["aiden", "serena", None, "aiden"]
MAX_NEW = 20
# Row 3 stops on its budget; the others on EOS or at MAX_NEW.
STEP_LIMIT = [MAX_NEW, MAX_NEW, MAX_NEW, 13]
MODES = ["float", "int8", "int8+kv"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_graph_loop_ckpt"))
    make_checkpoint(d)
    return d


def _greedy(max_new=MAX_NEW, ban_eos=False):
    gp = j_gen.GenerationParams(max_new_tokens=max_new).greedy()
    return dataclasses.replace(gp, min_new_tokens=max_new + 1 if ban_eos else 0)


def _inputs(model, bucket=8):
    """The four prompts batched as each package batches them."""
    if isinstance(model, JaxModel):
        prompts = [j_gen.build_prompt(model.talker_params, model.cfg, ROLE + c + TAIL,
                                      language="auto", speaker=s)
                   for c, s in zip(CONTENTS, SPEAKERS)]
        e, m, t, _ = j_gen.batch_prompts(prompts, bucket=bucket)
        return jnp.asarray(e, jnp.float32), jnp.asarray(m), jnp.asarray(t, jnp.float32)
    prompts = [t_gen.build_prompt(model.talker_params, model.cfg, ROLE + c + TAIL,
                                  language="auto", speaker=s)
               for c, s in zip(CONTENTS, SPEAKERS)]
    e, m, t, _ = t_gen.batch_prompts(prompts, bucket=bucket)
    return e, m, t


def _eos_token(codes0: np.ndarray) -> int:
    """Of the codebook-0 tokens of an EOS-banned run [B, T], the one whose
    first frames differ over the most rows (none at frame 0)."""
    best, best_spread = None, -1
    for v in sorted(set(codes0[:, 1:].ravel().tolist())):
        firsts = [int(np.argmax(row == v)) for row in codes0 if (row == v).any()]
        if 0 in firsts or len(firsts) < 2:
            continue
        if len(set(firsts)) > best_spread:
            best, best_spread = v, len(set(firsts))
    return best


@pytest.fixture(scope="module", params=MODES)
def models(ckpt, request):
    """JAX and port models in one mode, with the EOS column set to 1.01 x
    the column of ``_eos_token`` of the port's EOS-banned run."""
    jm = JaxModel.from_pretrained(ckpt, talker_dtype=jnp.float32, load_tokenizer=False)
    tm = TorchModel.from_pretrained(ckpt, talker_dtype=torch.float32, device="cpu",
                                    load_tokenizer=False)
    if request.param != "float":
        kv = request.param == "int8+kv"
        jm.quantize_for_serving(talker=True, kv=kv)
        tm.quantize_for_serving(talker=True, kv=kv)
    gp = _greedy(ban_eos=True)
    e, m, t = _inputs(tm)
    banned = t_gen.generate_codes(
        tm.talker_params, tm.subtalker_params, tm.cfg.talker, e, m, t,
        sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
        max_new_tokens=MAX_NEW, generator=None, kv_int8=tm.kv_int8)
    x = _eos_token(banned.codes[..., 0].numpy())
    eos = tm.cfg.talker.codec_eos_token_id
    head = tm.talker_params["codec_head"].clone()
    head[:, eos] = head[:, x] * 1.01
    tm.talker_params = dict(tm.talker_params, codec_head=head)
    jm.talker_params = dict(jm.talker_params, codec_head=jnp.asarray(head.numpy()))
    return jm, tm


def _jax_codes(jm, step_limit):
    gp = _greedy()
    e, m, t = _inputs(jm)
    out = j_gen.generate_codes(
        jm.talker_params, jm.subtalker_params, jm.cfg.talker, e, m, t,
        sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
        max_new_tokens=MAX_NEW, rng=jax.random.PRNGKey(0), kv_int8=jm.kv_int8,
        step_limit=jnp.asarray(step_limit, jnp.int32))
    return np.asarray(out.codes), np.asarray(out.num_gen), np.asarray(out.stopped)


def test_chunked_loop_matches_jax_generate_codes(models):
    jm, tm = models
    gp = _greedy()
    e, m, t = _inputs(tm)
    out = t_gen.generate_codes(
        tm.talker_params, tm.subtalker_params, tm.cfg.talker, e, m, t,
        sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
        max_new_tokens=MAX_NEW, generator=None, kv_int8=tm.kv_int8, step_limit=STEP_LIMIT)
    j_codes, j_num, j_stop = _jax_codes(jm, STEP_LIMIT)
    num_gen = out.num_gen.numpy()
    np.testing.assert_array_equal(num_gen, j_num)
    np.testing.assert_array_equal(out.stopped.numpy(), j_stop)
    for i, n in enumerate(num_gen):
        np.testing.assert_array_equal(out.codes[i, :n].numpy(), j_codes[i, :n])
    # Rows stop at different frames, some on EOS, all before MAX_NEW.
    assert len(set(num_gen.tolist())) >= 3 and out.stopped.any()
    assert num_gen.max() < MAX_NEW - 1


def _early_exit_loop(body, state, segment, step_limit, g):
    """The loop as it was before frames were chunked: the flag read before
    every frame, a stop at the first frame with no active row."""
    b = state.token.shape[0]
    buf = torch.zeros((b, segment, g), dtype=torch.int64)
    ticks = 0
    for tick in range(segment):
        if not bool((~state.eos & (state.num_gen < step_limit)).any()):
            break
        state, frame = body(state)
        buf[:, tick] = frame
        ticks += 1
    return state, buf, ticks


def _slot_mask(state, s_max):
    """[B, S_max] True at each row's next slot (its last when full)."""
    nxt = (state.prefix_len + state.num_gen).clamp(max=s_max - 1).long()
    return torch.arange(s_max)[None] == nxt[:, None]


@pytest.mark.parametrize("segment", [MAX_NEW, 17])
def test_chunked_loop_equals_the_early_exit_loop_bit_for_bit(models, segment):
    _, tm = models
    gp = _greedy()
    e, m, t = _inputs(tm)
    limit = torch.tensor(STEP_LIMIT, dtype=torch.int32)
    args = (tm.talker_params, tm.subtalker_params, tm.cfg.talker, gp.talker_sampling(),
            gp.subtalker_sampling())

    def start():
        return t_gen._prefill(tm.talker_params, tm.cfg.talker, e, m,
                              sampling=gp.talker_sampling(), max_cache_len=e.shape[1] + MAX_NEW,
                              generator=None, kv_int8=tm.kv_int8)

    body = t_gen._frame_body(*args, t, limit, None)
    old, old_buf, ticks = _early_exit_loop(body, start(), segment, limit,
                                           tm.cfg.talker.num_code_groups)
    new, new_buf = t_gen._decode_eager(*args, start(), t, limit, segment)
    assert ticks < segment and ticks % t_gen.CHECK_EVERY  # frames ran past all-done
    torch.testing.assert_close(new_buf, old_buf, rtol=0, atol=0)
    assert not new_buf[:, ticks:].any()
    for f in ("token", "hidden", "presence", "eos", "num_gen"):
        torch.testing.assert_close(getattr(new, f), getattr(old, f), rtol=0, atol=0)
    # The caches differ at most at each row's next slot.
    for a, b in ((new.k_cache, old.k_cache), (new.v_cache, old.v_cache)):
        for x, y in ((a["i8"], b["i8"]), (a["s"], b["s"])) if isinstance(a, dict) else ((a, b),):
            keep = ~_slot_mask(new, x.shape[2])[None]
            keep = keep.reshape(keep.shape + (1,) * (x.dim() - 3))
            torch.testing.assert_close(x * keep, y * keep, rtol=0, atol=0)


def test_streamed_segments_match_jax_decode_segment(models):
    """init_decode's first frames, then decode_segment in segments longer
    than a chunk, on both packages: each segment's codes and num_gen."""
    jm, tm = models
    gp = _greedy()
    kw = dict(sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling())
    first, segment = 3, t_gen.CHECK_EVERY + 3
    te, tmask, tt = _inputs(tm)
    je, jmask, jt = _inputs(jm)
    t_state, t_seg = t_gen.init_decode(
        tm.talker_params, tm.cfg.talker, te, tmask, max_cache_len=te.shape[1] + MAX_NEW,
        generator=None, kv_int8=tm.kv_int8, st_params=tm.subtalker_params,
        first_segment=first, trailing=tt, step_limit=STEP_LIMIT, **kw)
    j_state, j_seg = j_gen.init_decode(
        jm.talker_params, jm.subtalker_params, jm.cfg.talker, je, jmask,
        max_cache_len=je.shape[1] + MAX_NEW, rng=jax.random.PRNGKey(0), kv_int8=jm.kv_int8,
        first_segment=first, trailing=jt, step_limit=jnp.asarray(STEP_LIMIT, jnp.int32), **kw)
    for _ in range(3):
        t_num, j_num = t_state.num_gen.numpy(), np.asarray(j_state.num_gen)
        np.testing.assert_array_equal(t_num, j_num)
        np.testing.assert_array_equal(t_state.eos.numpy(), np.asarray(j_state.eos))
        np.testing.assert_array_equal(t_seg.numpy(), np.asarray(j_seg))
        t_state, t_seg = t_gen.decode_segment(
            tm.talker_params, tm.subtalker_params, tm.cfg.talker, t_state, tt,
            segment=segment, step_limit=STEP_LIMIT, **kw)
        j_state, j_seg = j_gen.decode_segment(
            jm.talker_params, jm.subtalker_params, jm.cfg.talker, j_state, jt,
            segment=segment, step_limit=jnp.asarray(STEP_LIMIT, jnp.int32), **kw)
    assert not (~t_state.eos & (t_state.num_gen < torch.tensor(STEP_LIMIT))).any()


class EagerGraph:
    """Stands in for ``graphs.Graph`` on the CPU: the capture is one more
    call, a replay calls the function again and writes what it returns into
    the tensors the capture returned, as a replay rewrites them in place."""

    def __init__(self, fn, generator=None):
        fn()  # the warm-up run
        before = graphs._counts()
        self.fn, self.generator, self.outputs = fn, generator, fn()
        graphs._take_back(before)

    def replay(self):
        def write(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            elif isinstance(dst, dict):
                for k in dst:
                    write(dst[k], src[k])
            elif isinstance(dst, tuple):
                for a, b in zip(dst, src):
                    write(a, b)
            elif dst is not None:
                for f in t_gen.STATE_FIELDS:
                    write(getattr(dst, f), getattr(src, f))

        write(self.outputs, self.fn())

    drawing_from = graphs.Graph.drawing_from


@pytest.fixture
def eager_graphs(monkeypatch):
    """The graph runners on the CPU: ``EagerGraph`` for ``graphs.Graph``,
    the flag read directly, no pinned host memory."""
    zeros = torch.zeros
    monkeypatch.setattr(graphs, "Graph", EagerGraph)
    monkeypatch.setattr(graphs, "read_flag", lambda flag, host: bool(flag))
    monkeypatch.setattr(torch, "zeros", lambda *a, pin_memory=False, **k: zeros(*a, **k))


@pytest.mark.parametrize("sampled", [False, True])
def test_graph_runners_keep_the_eager_results(models, eager_graphs, sampled):
    """The runners' own work around the replays, on the CPU: the frame
    runner copies a state in, pads the trailing text to its bucket, hands
    the caller's generator over and back and lends its buffers to the state
    it returns, and a state it lent keeps its values when another state is
    loaded; the first-packet runner copies its outputs out. Each segment and
    the first packet equal the eager functions' results bit for bit."""
    _, tm = models
    gp = dataclasses.replace(_greedy(), do_sample=sampled, subtalker_do_sample=sampled)
    e, m, t = _inputs(tm)
    tk = tm.cfg.talker
    args = (tm.talker_params, tm.subtalker_params, tk, gp.talker_sampling(),
            gp.subtalker_sampling())
    limit = torch.tensor(STEP_LIMIT, dtype=torch.int32)

    def start(seed):
        return t_gen._prefill(tm.talker_params, tk, e, m, sampling=gp.talker_sampling(),
                              max_cache_len=e.shape[1] + MAX_NEW,
                              generator=torch.Generator().manual_seed(seed), kv_int8=tm.kv_int8)

    rows = t_gen.trailing_rows(t)
    assert rows > t.shape[1]
    program = t_gen._FrameGraph(*args, start(0), t, limit, rows)
    want, got = start(0), start(0)
    for segment in (3, 12, 12):
        want, want_buf = t_gen._decode_eager(*args, want, t, limit, segment)
        got, buf = program.run(got, t, limit, segment)
        torch.testing.assert_close(buf, want_buf, rtol=0, atol=0)
        for f in ("token", "hidden", "presence", "eos", "num_gen"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0)
        torch.testing.assert_close(got.generator.get_state(), want.generator.get_state())
    assert got.token is program.state.token  # the next segment copies nothing
    kept = t_gen.clone_state(got)
    program.run(start(1), t, limit, 2)
    assert got.token is not program.state.token
    for f in ("token", "hidden", "presence", "eos", "num_gen"):
        torch.testing.assert_close(getattr(got, f), getattr(kept, f), rtol=0, atol=0)

    kw = dict(sampling=gp.talker_sampling(), st_sampling=gp.subtalker_sampling(),
              max_cache_len=e.shape[1] + MAX_NEW, first_segment=2, kv_int8=tm.kv_int8)
    first = t_pipeline._FirstPacketGraph(tm.talker_params, tm.subtalker_params,
                                         tm.codec_params, tk, tm.cfg.codec.decoder, e, m, t,
                                         MAX_NEW, rows, **kw)
    for seed in (2, 3):
        g_got, g_want = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        got = first.run(e, m, t, MAX_NEW, g_got)
        want = t_pipeline._first_packet_eager(
            tm.talker_params, tm.subtalker_params, tm.codec_params, tk, tm.cfg.codec.decoder,
            e, m, t, generator=g_want, step_limit=MAX_NEW, **kw)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for f in ("token", "hidden", "presence", "eos", "num_gen"):
            torch.testing.assert_close(getattr(got[0], f), getattr(want[0], f), rtol=0, atol=0)
        assert got[0].generator is g_got
        torch.testing.assert_close(g_got.get_state(), g_want.get_state())
        assert got[1].data_ptr() != first.graph.outputs[1].data_ptr()  # copied out
