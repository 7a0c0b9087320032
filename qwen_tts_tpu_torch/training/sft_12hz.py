"""SFT entry point: Base → CustomVoice finetuning on the port (the counterpart of
``scripts/sft_12hz.py``; the reference's ``finetuning/sft_12hz.py``).

Data: JSONL rows with "text" (or pre-tokenized "text_ids"), "audio_codes"
(from ``prepare_data``) and an optional "speaker_embedding".

    python -m qwen_tts_tpu_torch.training.sft_12hz --model-path BASE_CKPT \\
        --data train.jsonl --output-model-path out/ --speaker-name myvoice \\
        [--lr 5e-5] [--num-epochs 2] [--batch-size 2] [--remat] [--cpu] \\
        [--dp D] [--tp T]

Runs on the card unless ``--cpu``, in f32 master weights, one batch a step
through ``training/sft.py``'s deterministic train step. Each epoch writes
the inference checkpoint ``OUTPUT/checkpoint-epoch-<e>`` and the resumable
train state ``OUTPUT/train_state`` (``--resume`` restarts from it).

``--dp`` / ``--tp`` train on a (dp, tp) mesh (``parallel/mesh.py``): the
params split by the tp plan, each batch padded to a dp multiple with
loss-neutral rows (all masked) and its rows split over dp. Run alone with
dp x tp > 1, the script spawns its ranks (``torch.multiprocessing``, a file
rendezvous in a temporary directory); under a launcher (``torchrun``:
``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``) it uses the launcher's ranks.
The backend follows ``init_multihost``'s rule: NCCL when every rank has a
card of its own, gloo on the CPU or when ranks share a card. Rank 0 prints
and writes the checkpoints, which are the files one device writes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-path", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--output-model-path", required=True)
    p.add_argument("--speaker-name", required=True)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--resume", default=None, metavar="STATE_DIR",
                   help="resume from a train-state snapshot "
                        "(written to OUTPUT/train_state each epoch)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis (0 = single device)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (colwise/rowwise plan)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute trunk layers in the backward pass "
                        "(lower peak memory, a second forward; the same loss and gradients)")
    return p.parse_args(argv)


def shard_batch(batch, mesh):
    """``batch`` padded to a dp multiple with loss-neutral rows (no real
    position, no label, no frame: the cross-entropy is normalised by the
    global mask count) and this rank's rows of it."""
    import torch

    from qwen_tts_tpu_torch.parallel.mesh import mesh_place, shard_rows

    n = (-batch.pad_mask.shape[0]) % mesh_place(mesh).dp_size
    if n:
        def pad(x, fill):
            return torch.cat([x, x.new_full((n,) + tuple(x.shape[1:]), fill)], dim=0)

        batch = type(batch)(
            inputs_embeds=pad(batch.inputs_embeds, 0), pad_mask=pad(batch.pad_mask, False),
            codec0_labels=pad(batch.codec0_labels, -100), group_labels=pad(batch.group_labels, 0),
            frame_mask=pad(batch.frame_mask, False))
    return type(batch)(*(shard_rows(mesh, x) for x in batch))


def train(args: argparse.Namespace, on_step: Optional[Callable] = None) -> int:
    """The training run ``args`` describe. ``on_step(step, batch, loss,
    aux)``, when given, is called after every step with its results (device
    tensors; on a mesh the rank's rows and the global loss). With ``--dp`` /
    ``--tp`` it needs a process group or a launcher's environment
    (``init_multihost``); ``main`` spawns the ranks when there is neither."""
    from qwen_tts_tpu_torch.training.sft import DETERMINISTIC_CUBLAS

    # Deterministic cuBLAS needs this before its first use in the process.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", DETERMINISTIC_CUBLAS)

    import numpy as np
    import torch

    from qwen_tts_tpu_torch.io.loader import load_checkpoint
    from qwen_tts_tpu_torch.io.saver import save_finetuned_checkpoint
    from qwen_tts_tpu_torch.parallel.multihost import writes_files
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel, load_text_tokenizer
    from qwen_tts_tpu_torch.training.checkpoint import load_train_state, save_train_state
    from qwen_tts_tpu_torch.training.data import collate, examples_from_jsonl, load_jsonl
    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step
    from qwen_tts_tpu_torch.utils import resolve_device

    mesh, sharding = None, None
    dp = max(args.dp, 1)
    if args.dp or args.tp > 1:
        import torch.distributed as dist

        from qwen_tts_tpu_torch.parallel.mesh import make_mesh
        from qwen_tts_tpu_torch.parallel.multihost import init_multihost

        if not init_multihost(device_type="cpu" if args.cpu else "cuda"):
            raise RuntimeError("--dp / --tp need a process group: run the script itself "
                               "(it spawns its ranks) or under a launcher")
        mesh = make_mesh(dp * args.tp, tp=args.tp)
    device = resolve_device("cpu" if args.cpu else None)
    writer = writes_files()
    # Train in f32 (master weights); the export keeps them f32.
    cfg, talker, subtalker, _codec, _speaker = load_checkpoint(
        args.model_path, talker_dtype=torch.float32, device=device)
    del _codec, _speaker
    # The text tokenizer (``transformers``, seconds to import) only where a
    # row carries text instead of ids.
    tokenizer = (None if all("text_ids" in row for row in load_jsonl(args.data))
                 else load_text_tokenizer(args.model_path))
    examples = examples_from_jsonl(args.data, tokenizer,
                                   Qwen3TTSModel.build_assistant_text)
    if writer:
        print(f"{len(examples)} training examples")
    talker_cfg = cfg.talker
    if mesh is not None:
        from qwen_tts_tpu_torch.parallel.mesh import shard_params

        shards = shard_params(mesh, talker, subtalker, cfg.talker)
        talker, subtalker, talker_cfg, sharding = shards
        if writer:
            print(f"mesh: dp={dp} tp={args.tp} over {dp * args.tp} devices, "
                  f"backend {dist.get_backend()}")

    # The first example's speaker embedding is the voice the export bakes in.
    target_speaker_embedding = next(
        (e.speaker_embedding for e in examples if e.speaker_embedding is not None), None)

    params = {"talker": talker, "subtalker": subtalker}
    optimizer = make_optimizer(args.lr, weight_decay=0.01, grad_clip=args.grad_clip)
    opt_state = optimizer.init(params)
    train_step = make_train_step(talker_cfg, optimizer, remat=args.remat, sharding=sharding)

    step, start_epoch = 0, 0
    if args.resume:
        params, opt_state, meta = load_train_state(args.resume, params, optimizer, sharding)
        step, start_epoch = meta["step"], meta["epoch"]
        if writer:
            print(f"resumed from {args.resume} (epoch {start_epoch}, step {step})")

    for epoch in range(start_epoch, args.num_epochs):
        order = np.random.default_rng(epoch).permutation(len(examples))
        for i in range(0, len(order), args.batch_size):
            batch_ex = [examples[j] for j in order[i : i + args.batch_size]]
            batch = collate(batch_ex, cfg, params["talker"], params["subtalker"])
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            params, opt_state, loss, aux = train_step(params, opt_state, batch)
            if on_step is not None:
                on_step(step, batch, loss, aux)
            if step % 10 == 0 and writer:
                print(f"epoch {epoch} | step {step} | "
                      f"loss {float(loss):.6f} "
                      f"(talker {float(aux['talker_ce']):.4f}, "
                      f"subtalker {float(aux['subtalker_ce']):.4f})")
            step += 1

        out_dir = os.path.join(args.output_model_path, f"checkpoint-epoch-{epoch}")
        save_finetuned_checkpoint(
            args.model_path, out_dir, params["talker"], params["subtalker"],
            speaker_name=args.speaker_name,
            speaker_embedding=target_speaker_embedding,
            speaker_slot=min(3000, cfg.talker.vocab_size - 1),
            sharding=sharding,
        )
        # The resumable train state (params, optimizer, counters): what
        # --resume restarts from after an interruption.
        state_dir = os.path.join(args.output_model_path, "train_state")
        save_train_state(state_dir, params, opt_state, step=step, epoch=epoch + 1,
                         sharding=sharding)
        if writer:
            print(f"saved {out_dir}")
            print(f"saved train state {state_dir}")
        if mesh is not None:
            dist.barrier()  # the files are whole before any rank reads them
    return 0


def _spawned_rank(rank: int, argv: List[str], world: int, init_method: str) -> None:
    """One rank of a run that ``main`` spawned."""
    from qwen_tts_tpu_torch.parallel.multihost import init_multihost

    args = parse_args(argv)
    init_multihost(init_method, world, rank, device_type="cpu" if args.cpu else "cuda")
    try:
        rc = train(args)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    world = max(args.dp, 1) * args.tp
    if world == 1 or "MASTER_ADDR" in os.environ:
        return train(args)
    import tempfile

    import torch.multiprocessing as mp

    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as rendezvous:
        mp.start_processes(_spawned_rank, args=(argv, world, f"file://{rendezvous}/store"),
                           nprocs=world, start_method="spawn", join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
