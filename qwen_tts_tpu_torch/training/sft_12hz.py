"""SFT entry point: Base → CustomVoice finetuning on the port (the counterpart of
``scripts/sft_12hz.py``; the reference's ``finetuning/sft_12hz.py``).

Data: JSONL rows with "text" (or pre-tokenized "text_ids"), "audio_codes"
(from ``prepare_data``) and an optional "speaker_embedding".

    python -m qwen_tts_tpu_torch.training.sft_12hz --model-path BASE_CKPT \\
        --data train.jsonl --output-model-path out/ --speaker-name myvoice \\
        [--lr 5e-5] [--num-epochs 2] [--batch-size 2] [--remat] [--cpu]

Runs on the card unless ``--cpu``, in f32 master weights, one batch a step
through ``training/sft.py``'s deterministic train step. Each epoch writes
the inference checkpoint ``OUTPUT/checkpoint-epoch-<e>`` and the resumable
train state ``OUTPUT/train_state`` (``--resume`` restarts from it). The JAX
script's ``--dp`` / ``--tp`` meshes wait for the port's parallelism.
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
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute trunk layers in the backward pass "
                        "(lower peak memory, a second forward; the same loss and gradients)")
    return p.parse_args(argv)


def train(args: argparse.Namespace, on_step: Optional[Callable] = None) -> int:
    """The training run ``args`` describe. ``on_step(step, batch, loss,
    aux)``, when given, is called after every step with its results (device
    tensors)."""
    from qwen_tts_tpu_torch.training.sft import DETERMINISTIC_CUBLAS

    # Deterministic cuBLAS needs this before its first use in the process.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", DETERMINISTIC_CUBLAS)

    import numpy as np
    import torch

    from qwen_tts_tpu_torch.io.loader import load_checkpoint
    from qwen_tts_tpu_torch.io.saver import save_finetuned_checkpoint
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel, load_text_tokenizer
    from qwen_tts_tpu_torch.training.checkpoint import load_train_state, save_train_state
    from qwen_tts_tpu_torch.training.data import collate, examples_from_jsonl
    from qwen_tts_tpu_torch.training.sft import make_optimizer, make_train_step
    from qwen_tts_tpu_torch.utils import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    # Train in f32 (master weights); the export keeps them f32.
    cfg, talker, subtalker, _codec, _speaker = load_checkpoint(
        args.model_path, talker_dtype=torch.float32, device=device)
    del _codec, _speaker
    examples = examples_from_jsonl(args.data, load_text_tokenizer(args.model_path),
                                   Qwen3TTSModel.build_assistant_text)
    print(f"{len(examples)} training examples")

    # The first example's speaker embedding is the voice the export bakes in.
    target_speaker_embedding = next(
        (e.speaker_embedding for e in examples if e.speaker_embedding is not None), None)

    params = {"talker": talker, "subtalker": subtalker}
    optimizer = make_optimizer(args.lr, weight_decay=0.01, grad_clip=args.grad_clip)
    opt_state = optimizer.init(params)
    train_step = make_train_step(cfg.talker, optimizer, remat=args.remat)

    step, start_epoch = 0, 0
    if args.resume:
        params, opt_state, meta = load_train_state(args.resume, params, optimizer)
        step, start_epoch = meta["step"], meta["epoch"]
        print(f"resumed from {args.resume} (epoch {start_epoch}, step {step})")

    for epoch in range(start_epoch, args.num_epochs):
        order = np.random.default_rng(epoch).permutation(len(examples))
        for i in range(0, len(order), args.batch_size):
            batch_ex = [examples[j] for j in order[i : i + args.batch_size]]
            batch = collate(batch_ex, cfg, params["talker"], params["subtalker"])
            params, opt_state, loss, aux = train_step(params, opt_state, batch)
            if on_step is not None:
                on_step(step, batch, loss, aux)
            if step % 10 == 0:
                print(f"epoch {epoch} | step {step} | "
                      f"loss {float(loss):.4f} "
                      f"(talker {float(aux['talker_ce']):.4f}, "
                      f"subtalker {float(aux['subtalker_ce']):.4f})")
            step += 1

        out_dir = os.path.join(args.output_model_path, f"checkpoint-epoch-{epoch}")
        save_finetuned_checkpoint(
            args.model_path, out_dir, params["talker"], params["subtalker"],
            speaker_name=args.speaker_name,
            speaker_embedding=target_speaker_embedding,
            speaker_slot=min(3000, cfg.talker.vocab_size - 1),
        )
        print(f"saved {out_dir}")
        # The resumable train state (params, optimizer, counters): what
        # --resume restarts from after an interruption.
        state_dir = os.path.join(args.output_model_path, "train_state")
        save_train_state(state_dir, params, opt_state, step=step, epoch=epoch + 1)
        print(f"saved train state {state_dir}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    return train(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
