"""``qwen-tts`` command line of the PyTorch port (the flags of
``qwen_tts_tpu/cli.py``): chat-template token ids (or text, with the
checkpoint's tokenizer) in, a WAV out; sampling controls, verbosity, the
in-process benchmark loop (``--benchmark-runs`` / ``--benchmark-warmup``,
one ``[persistent] run k/N`` line on stderr per measured run), voice design
(``--instruct``) and voice clone (``--ref-audio``, ``--ref-text``,
``--x-vector-only``, ``--voice-file``, ``--save-voice``). The model runs on
the CUDA device.

    python -m qwen_tts_tpu_torch -d MODEL_DIR -t 151644,77091,198,... -o out.wav
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List

import numpy as np


def _read_token_file(path: str) -> List[int]:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return [int(part) for part in text.replace(",", "\n").split() if part.strip()]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen-tts",
        description="Qwen3-TTS — text-to-speech inference (PyTorch, CUDA)",
    )
    p.add_argument("-d", dest="model_dir", required=True,
                   help="Model directory (config.json + safetensors)")
    p.add_argument("-t", dest="tokens",
                   help="Comma-separated BPE token IDs in chat template format")
    p.add_argument("-f", dest="token_file",
                   help="Read token IDs from file (one per line or comma-separated)")
    p.add_argument("--text", dest="text",
                   help="Raw text (requires the checkpoint's HF tokenizer)")
    p.add_argument("-s", dest="speaker", default=None, help="Speaker name")
    p.add_argument("-l", dest="language", default="auto",
                   help="Language: auto, chinese, english, ...")
    p.add_argument("-o", dest="output", default="output.wav", help="Output WAV")
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--fixed-codec-tokens", type=int, default=0,
                   help="Generate exactly n codec tokens (ignore EOS before n)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--greedy", action="store_true",
                   help="Deterministic decode (top-k 1 equivalent; parity mode)")
    p.add_argument("--subtalker-temperature", type=float, default=None)
    p.add_argument("--subtalker-top-k", type=int, default=None)
    p.add_argument("--subtalker-top-p", type=float, default=None)
    p.add_argument("--benchmark-runs", type=int, default=1)
    p.add_argument("--benchmark-warmup", type=int, default=0)
    p.add_argument("--instruct", default=None, help="voice-design instruction text")
    p.add_argument("--non-streaming", action="store_true",
                   help="non-streaming prompt schema (whole text before codec_bos)")
    p.add_argument("--ref-audio", default=None,
                   help="voice clone: reference WAV path/URL/base64")
    p.add_argument("--ref-text", default=None,
                   help="voice clone: reference transcript (ICL mode)")
    p.add_argument("--x-vector-only", action="store_true",
                   help="voice clone: timbre only, no ICL splice")
    p.add_argument("--voice-file", default=None,
                   help="voice clone: saved voice file (.pt/.npz)")
    p.add_argument("--save-voice", default=None,
                   help="persist the built clone prompt as a voice file")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from qwen_tts_tpu_torch.generate import build_prompt, icl_ref_codes
    from qwen_tts_tpu_torch.io.wav import write_wav
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    verbose = args.verbose

    def log(level, msg):
        if verbose >= level:
            print(msg, file=sys.stderr)

    t0 = time.perf_counter()
    model = Qwen3TTSModel.from_pretrained(args.model_dir)
    log(1, f"Model loaded in {time.perf_counter() - t0:.1f} s")

    if args.tokens:
        ids = np.asarray([int(x) for x in args.tokens.split(",") if x.strip()], np.int64)
    elif args.token_file:
        ids = np.asarray(_read_token_file(args.token_file), np.int64)
    elif args.text:
        ids = model._tokenize(model.build_assistant_text(args.text))
    else:
        print("error: one of -t / -f / --text is required", file=sys.stderr)
        return 2
    if ids.shape[0] < 8:
        print("error: need at least 8 token ids (chat template format)", file=sys.stderr)
        return 2

    params = model._merge_params(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty, max_new_tokens=args.max_tokens,
        subtalker_temperature=args.subtalker_temperature,
        subtalker_top_k=args.subtalker_top_k, subtalker_top_p=args.subtalker_top_p,
        seed=args.seed,
    )
    if args.greedy:
        params = params.greedy()
    if args.fixed_codec_tokens > 0:
        params = dataclasses.replace(params, max_new_tokens=args.fixed_codec_tokens,
                                     min_new_tokens=args.fixed_codec_tokens)

    clone_prompt = None
    if args.voice_file:
        clone_prompt = model.load_voice_clone_prompt(args.voice_file)
    elif args.ref_audio:
        clone_prompt = model.create_voice_clone_prompt(
            args.ref_audio, ref_text=args.ref_text, x_vector_only_mode=args.x_vector_only)
    if clone_prompt is not None and args.save_voice:
        model.save_voice_clone_prompt(clone_prompt, args.save_voice)
        log(0, f"Saved voice file {args.save_voice}")
    speaker_embed = ref_ids = ref_codes = None
    if clone_prompt is not None:
        speaker_embed, ref_ids, ref_codes = model.clone_prompt_inputs(clone_prompt)
    if ref_codes is not None:
        try:
            ref_codes = icl_ref_codes(ref_codes, model.cfg.talker.num_code_groups)
        except ValueError as e:
            raise SystemExit(f"{e}: incompatible voice file for this model")
    instr_ids = (model._tokenize(model.build_instruct_text(args.instruct))
                 if args.instruct else None)

    prompt = build_prompt(
        model.talker_params, model.cfg, ids, language=args.language, speaker=args.speaker,
        speaker_embed=speaker_embed, ref_ids=ref_ids, ref_codes=ref_codes,
        instruct_ids=instr_ids, non_streaming=args.non_streaming,
        st_params=model.subtalker_params,
    )

    total_runs = args.benchmark_warmup + args.benchmark_runs
    wav = None
    for run in range(total_runs):
        measured = run >= args.benchmark_warmup
        t_gen = time.perf_counter()
        codes, info = model.generate_codes_from_prompts(
            [prompt], params,
            # --fixed-codec-tokens keeps all n frames; by default a row that
            # ran out of budget drops its final, unexpanded frame.
            trim_last_on_budget=args.fixed_codec_tokens <= 0,
        )
        n = codes[0].shape[0]
        t_talker = time.perf_counter() - t_gen
        log(1, f"Generated {n} codec tokens in {t_talker * 1e3:.1f} ms "
               f"({t_talker * 1e3 / max(n, 1):.1f} ms/token)")
        log(1, f"Stop: {'eos' if info['stopped'][0] else 'max_tokens'} at step {n}")
        if verbose >= 2:
            log(2, "Token trace: " + ",".join(str(x) for x in codes[0][:, 0]))

        t_codec = time.perf_counter()
        if ref_codes is not None:
            # ICL: the reference codes lead the codec decode; their audio is cut.
            merged = np.concatenate([ref_codes.astype(np.int32), codes[0]], axis=0)
            up = model.cfg.codec.decode_upsample_rate
            wav = model.decode_codes([merged])[0][ref_codes.shape[0] * up:]
        else:
            wav = model.decode_codes(codes)[0]
        t_codec = time.perf_counter() - t_codec
        total = time.perf_counter() - t_gen
        audio_sec = wav.shape[0] / model.sample_rate
        log(1, f"Codec decode: {wav.shape[0]} samples in {t_codec * 1e3:.1f} ms")
        log(1, f"Total: {total * 1e3:.1f} ms ({audio_sec:.2f} s audio, "
               f"{audio_sec / total:.2f}x realtime)")
        if total_runs > 1 and measured:
            idx = run - args.benchmark_warmup + 1
            print(f"[persistent] run {idx}/{args.benchmark_runs} "
                  f"talker_ms={t_talker * 1e3:.1f} codec_ms={t_codec * 1e3:.1f} "
                  f"tokens={n}", file=sys.stderr)

    if wav is not None:
        write_wav(args.output, wav, model.sample_rate)
        log(0, f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
