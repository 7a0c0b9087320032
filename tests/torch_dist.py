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
