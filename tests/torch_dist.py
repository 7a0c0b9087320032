"""Multi-rank runs for the port's CPU tests of ``qwen_tts_tpu_torch/parallel``.

``run_ranks`` starts each rank as a fresh Python process (never a fork: the
test process holds JAX's threads) in a gloo group that rendezvouses through
a file in the test's directory (no ports to race under xdist), runs one of
the rank bodies below on the arguments it was given (``torch.save``d there),
and returns every rank's result. Every rank has a deadline: a rank that
fails or outlives it fails the test with its output, and the others are
killed. The bodies import torch and the port only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANK_TIMEOUT = 240.0

_CHILD = """
import sys, importlib
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from qwen_tts_tpu_torch.parallel.multihost import init_multihost
target, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
init_multihost(f"file://{work}/store", world, rank, device_type="cpu")
mod, fn = target.split(":")
kwargs = torch.load(f"{work}/args.pt", weights_only=False)
out = getattr(importlib.import_module(mod), fn)(**kwargs)
torch.save(out, f"{work}/out{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(target: str, world: int, workdir, timeout: float = RANK_TIMEOUT, **kwargs):
    """``target`` ("module:function", importable from ``tests/``) on
    ``world`` ranks of a fresh gloo group; returns the ranks' results in
    rank order."""
    work = str(workdir)
    os.makedirs(work, exist_ok=True)
    torch.save(kwargs, os.path.join(work, "args.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, TESTS] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])),
        OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, target, str(r), str(world), work],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    failures = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failures.append(f"rank {r} outlived {timeout} s")
                break
            if p.returncode != 0:
                failures.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failures, "\n".join(failures)
    return [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------
# rank bodies


def decode(talker, subtalker, cfg, embeds, mask, trailing, meshes, max_new, seed):
    """Greedy and sampled ``generate_codes`` of the batch on each mesh
    ``(tp, sample)`` of ``meshes``: {(tp, sample): (codes, num_gen) of this
    rank's rows}."""
    from qwen_tts_tpu_torch.generate import generate_codes
    from qwen_tts_tpu_torch.ops.sampling import SamplingConfig
    from qwen_tts_tpu_torch.parallel import comm
    from qwen_tts_tpu_torch.parallel.mesh import make_mesh, shard_params, shard_rows

    out = {}
    for tp, sample in meshes:
        mesh = make_mesh(tp=tp)
        shards = shard_params(mesh, talker, subtalker, cfg)
        rows = [shard_rows(mesh, x) for x in (embeds, mask, trailing)]
        talker_s = SamplingConfig(do_sample=sample, top_k=8, temperature=0.9,
                                  repetition_penalty=1.0 if not sample else 1.05,
                                  min_new_tokens=max_new)
        st_s = SamplingConfig(do_sample=sample, top_k=8, temperature=0.9)
        before = comm.all_reduce.calls
        res = generate_codes(shards.talker, shards.subtalker, shards.cfg, *rows,
                             sampling=talker_s, st_sampling=st_s, max_new_tokens=max_new,
                             generator=torch.Generator().manual_seed(seed))
        out[(tp, sample)] = (res.codes, res.num_gen, comm.all_reduce.calls - before,
                             shards.cfg.num_key_value_heads)
    return out


def train_steps(params, cfg, batch, steps, lr, workdir):
    """``steps`` SFT steps at dp 2 x tp 2 on this rank's rows of ``batch``
    (padded to a dp multiple), then a snapshot of the train state and its
    restore into fresh shards: the losses, the params after the steps
    (gathered), the restore's leaves against the saved ones."""
    from qwen_tts_tpu_torch.parallel.mesh import make_mesh, shard_params
    from qwen_tts_tpu_torch.training import sft_12hz
    from qwen_tts_tpu_torch.training.checkpoint import load_train_state, save_train_state
    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step

    mesh = make_mesh(tp=2)
    shards = shard_params(mesh, params["talker"], params["subtalker"], cfg)
    local = {"talker": shards.talker, "subtalker": shards.subtalker}
    opt = make_optimizer(lr, weight_decay=0.01)
    state = opt.init(local)
    step = make_train_step(shards.cfg, opt, sharding=shards.sharding)
    rows = sft_12hz.shard_batch(batch, mesh)
    losses = []
    for _ in range(steps):
        local, state, loss, aux = step(local, state, rows)
        losses.append((float(loss), float(aux["talker_ce"]), float(aux["subtalker_ce"])))
    snap = os.path.join(workdir, "state")
    save_train_state(snap, local, state, step=steps, sharding=shards.sharding)
    torch.distributed.barrier()
    # The params restore into new tensors shaped as the template, the
    # optimizer state into ``opt.init`` of it.
    restored, restored_state, meta = load_train_state(snap, local, opt, shards.sharding)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(restored), _leaves(local))) and all(
        torch.equal(a, b) for a, b in zip(_leaves(restored_state), _leaves(state)))
    gathered = shards.sharding.gather_tree(local)
    return {"losses": losses, "params": gathered, "restored_equal": same, "meta": meta,
            "rank_heads": (shards.cfg.num_attention_heads, shards.cfg.num_key_value_heads)}


def _leaves(tree):
    from qwen_tts_tpu_torch.training.sft import tree_leaves

    return tree_leaves(tree)


def vq_steps(state, params, xs, seeds, cfg):
    """The dp VQ step (the world's ranks) on this rank's rows of each batch
    in ``xs``, in lockstep: each step's (state, indices of this rank's rows,
    loss)."""
    import torch.distributed as dist

    from qwen_tts_tpu_torch.training.vq import make_sharded_vq_train_step

    rank, world = dist.get_rank(), dist.get_world_size()
    step = make_sharded_vq_train_step(dist.group.WORLD, cfg)
    out = []
    for x, seed in zip(xs, seeds):
        rows = x.shape[0] // world
        state, res = step(state, params, x[rank * rows:(rank + 1) * rows],
                          torch.Generator().manual_seed(seed))
        out.append((state, res.indices, res.loss))
    return out


def train_and_vq(sft: dict, vq: list):
    """``train_steps(**sft)`` and ``vq_steps(**run)`` for each run of
    ``vq``, in one group."""
    return train_steps(**sft), [vq_steps(**run) for run in vq]


def _tp_model(cfg, talker, subtalker, codec):
    """A ``Qwen3TTSModel`` on this rank's tp shards of the world (the codec
    whole)."""
    import dataclasses

    from qwen_tts_tpu_torch.parallel.mesh import make_mesh, shard_params
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    mesh = make_mesh(tp=torch.distributed.get_world_size())
    shards = shard_params(mesh, talker, subtalker, cfg.talker)
    return Qwen3TTSModel(dataclasses.replace(cfg, talker=shards.cfg), shards.talker,
                         shards.subtalker, codec)


def tp_engine(cfg, talker, subtalker, codec, requests, wait):
    """``ContinuousBatchingEngine`` on a tp group of the world's ranks (f32
    on the CPU): tp rank 0 leads and takes ``requests`` in turn, every other
    rank runs ``follow()``. Each request is (name, ids, params, what):
    ``what`` "wait" submits and waits for the result, "batch" submits without
    waiting (the next "wait" waits for every pending one), "cancel" submits,
    waits for a segment that holds it and cancels it, "poison" submits a
    prompt one hidden unit too wide, "oversize" a prompt over the largest
    bucket. Every rank records each segment's frame budgets (as
    ``decode_segment`` was given them) and codes; the leader also the
    commands it broadcast, what it handed the codec, each result or error,
    and when it called ``stop()``; a follower when ``follow()`` returned."""
    import time

    import numpy as np

    from qwen_tts_tpu_torch import continuous
    from qwen_tts_tpu_torch.generate import Prompt, build_prompt

    model = _tp_model(cfg, talker, subtalker, codec)
    segments, commands, decoded = [], [], []
    segment = continuous.decode_segment

    def recording(*args, step_limit, **kw):
        limits = step_limit.clone()
        state, codes, report = segment(*args, step_limit=step_limit, **kw)
        segments.append((limits, codes.clone()))
        return state, codes, report

    continuous.decode_segment = recording
    engine = continuous.ContinuousBatchingEngine(
        model, num_slots=2, segment_frames=2, max_new_tokens=16, prefill_bucket=32,
        trailing_cap=32)
    out = {"leader": engine.is_leader, "segments": segments}
    if not engine.is_leader:
        engine.follow()
        out["returned"] = time.time()
        out["failed_admits"] = engine.stats["failed_admits"]
        return out

    tell = engine._tell
    engine._tell = lambda command: (commands.append(command[0]), tell(command))[1]
    decode = model.decode_codes
    model.decode_codes = lambda codes, **kw: (
        decoded.extend(np.asarray(c).copy() for c in codes), decode(codes, **kw))[1]
    results, pending = {}, {}

    def prompt_of(ids, width=0):
        p = build_prompt(model.talker_params, model.cfg, np.asarray(ids), language="english",
                         speaker="aiden")
        return Prompt(*(torch.nn.functional.pad(t, (0, width)) for t in p)) if width else p

    engine.start()
    try:
        for name, ids, params, what in requests:
            if what == "oversize":
                try:
                    p = prompt_of(ids)
                    engine.submit_prompt(p._replace(embeds=p.embeds.repeat(4, 1)), params)
                    results[name] = "accepted"
                except ValueError as exc:
                    results[name] = f"refused: {exc}"
                continue
            fut = engine.submit_prompt(prompt_of(ids, 1 if what == "poison" else 0), params)
            pending[name] = fut
            if what == "cancel":
                req = engine._req_by_future[id(fut)]
                deadline = time.monotonic() + wait
                while not any(r is req for r in engine._slot_req.values()):
                    assert time.monotonic() < deadline, "the request was never admitted"
                    time.sleep(0.002)
                seen = engine.stats["segments"]
                while engine.stats["segments"] < seen + 1:
                    assert time.monotonic() < deadline, "no segment ran"
                    time.sleep(0.002)
                engine.cancel(fut)
            if what == "batch":
                continue
            for key, f in pending.items():
                try:
                    results[key] = f.result(timeout=wait)
                except Exception as exc:  # recorded for the test
                    results[key] = f"{type(exc).__name__}: {exc}"
            pending.clear()
    finally:
        out["stop"] = time.time()
        engine.stop()
    out.update(results=results, commands=commands, decoded=decoded,
               requests=engine.stats["requests"], failed_admits=engine.stats["failed_admits"])
    return out


def tp_windows(cfg, talker, subtalker, codec, queued, later, wait):
    """``ServingEngine`` on a tp group of the world's ranks (f32 on the
    CPU): tp rank 0 leads, every other rank runs ``follow()``. The leader
    first calls ``follow()`` (a wrong role), submits ``queued`` before
    ``start()`` (one window per set of sampling controls), waits for them,
    then submits each of ``later`` alone and waits for it. Each request is
    (name, ids, submit_ids keywords, pad): ``pad`` widens the prompt by that
    many hidden units. A follower first calls ``start()`` and ``submit_ids``
    (wrong roles). Every rank records each window's frame budgets and codes
    as ``_decode_window`` returned them; the leader also what it handed the
    codec, each result or error and when it called ``stop()``; a follower
    when ``follow()`` returned."""
    import time

    import numpy as np

    from qwen_tts_tpu_torch import serving
    from qwen_tts_tpu_torch.generate import Prompt

    model = _tp_model(cfg, talker, subtalker, codec)
    engine = serving.ServingEngine(model, max_batch=4, max_wait_ms=200, max_new_tokens=16)
    windows, wrong = [], []
    decode_window = engine._decode_window

    def recording(prompts, params, limits, *args):
        codes, info = decode_window(prompts, params, limits, *args)
        windows.append((list(limits), [c.copy() for c in codes], params.do_sample))
        return codes, info

    engine._decode_window = recording
    out = {"leader": engine.is_leader, "windows": windows, "wrong": wrong}

    def attempt(name, fn, *args, **kw):
        try:
            fn(*args, **kw)
            wrong.append((name, "allowed"))
        except RuntimeError as exc:
            wrong.append((name, str(exc)))

    if not engine.is_leader:
        attempt("start", engine.start)
        attempt("submit_ids", engine.submit_ids, np.asarray(queued[0][1]), **queued[0][2])
        engine.follow()
        out.update(returned=time.time(), failed_windows=engine.stats["failed_windows"])
        return out

    attempt("follow", engine.follow)
    decode = model.decode_codes
    decoded = []
    model.decode_codes = lambda codes, **kw: (
        decoded.extend(np.asarray(c).copy() for c in codes), decode(codes, **kw))[1]
    build = serving._build_prompt
    results = {}

    def submit(ids, kw, pad):
        serving._build_prompt = build if not pad else lambda *a, **k: Prompt(
            *(torch.nn.functional.pad(t, (0, pad)) for t in build(*a, **k)))
        try:
            return engine.submit_ids(np.asarray(ids), **kw)
        finally:
            serving._build_prompt = build

    def settle(futures):
        for name, f in futures.items():
            try:
                results[name] = f.result(timeout=wait)
            except Exception as exc:  # recorded for the test
                results[name] = f"{type(exc).__name__}: {exc}"

    futures = {name: submit(ids, kw, pad) for name, ids, kw, pad in queued}
    engine.start()
    try:
        settle(futures)
        for name, ids, kw, pad in later:
            settle({name: submit(ids, kw, pad)})
    finally:
        out["stop"] = time.time()
        engine.stop()
    out.update(results=results, decoded=decoded, stats=dict(engine.stats))
    return out


class FixedTokenizer:
    """A text tokenizer that gives the same ids for every text."""

    def __init__(self, ids):
        self.ids = list(ids)

    def __call__(self, text):
        return {"input_ids": self.ids}


def tp_stream(cfg, talker, subtalker, codec, ids, speaker, language, kwargs):
    """``stream_custom_voice`` on this rank's tp shards (every rank streams):
    the chunks, every frame its segments generated (from each segment's
    ``num_gen`` delta) and the rank's talker heads."""
    import numpy as np

    from qwen_tts_tpu_torch import pipeline

    model = _tp_model(cfg, talker, subtalker, codec)
    model.tokenizer = FixedTokenizer(ids)
    frames = []

    def recording(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            state, seg = out[0], out[1]
            n = int(state.num_gen[0])
            frames.extend(seg[0, : n - len(frames)].numpy().astype(np.int64))
            return out
        return wrapped

    pipeline._first_packet_program = recording(pipeline._first_packet_program)
    pipeline.decode_segment = recording(pipeline.decode_segment)
    chunks = [w for w, _ in model.stream_custom_voice("text", speaker, language, **kwargs)]
    return {"chunks": chunks, "frames": np.stack(frames),
            "heads": (model.cfg.talker.num_attention_heads,
                      model.cfg.talker.num_key_value_heads)}
