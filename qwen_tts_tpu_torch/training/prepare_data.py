"""SFT data prep on the port (the counterpart of ``scripts/prepare_data.py``;
the reference's ``finetuning/prepare_data.py``): batch-encode target audio
into 12 Hz codec codes with the port's Mimi encoder (``codec_encoder.py``).

Input JSONL rows: {"audio": wav_path, "text": ..., ["ref_audio": wav_path]}.
Output rows gain "audio_codes" ([T, Q] lists) and, when the checkpoint has a
speaker encoder and the row a "ref_audio", "speaker_embedding".

    python -m qwen_tts_tpu_torch.training.prepare_data --model-path CKPT \\
        --input in.jsonl --output out.jsonl [--batch-size 32] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-path", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from qwen_tts_tpu_torch.audio import resample
    from qwen_tts_tpu_torch.codec_encoder import SpeechTokenizerEncoder
    from qwen_tts_tpu_torch.io.wav import read_wav
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
    from qwen_tts_tpu_torch.utils import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    encoder = SpeechTokenizerEncoder.from_pretrained(
        os.path.join(args.model_path, "speech_tokenizer"), device=device)
    model = None  # loaded at the first row that needs a speaker embedding

    with open(args.input, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f if line.strip()]

    out_rows = []
    for start in range(0, len(rows), args.batch_size):
        chunk = rows[start : start + args.batch_size]
        wavs = []
        for row in chunk:
            wav, sr = read_wav(row["audio"])
            wavs.append(resample(wav, sr, encoder.input_sample_rate))
        codes = encoder.encode(wavs, encoder.input_sample_rate)
        for row, c in zip(chunk, codes):
            row = dict(row)
            row["audio_codes"] = c.tolist()
            if "ref_audio" in row:
                if model is None:
                    model = Qwen3TTSModel.from_pretrained(
                        args.model_path, load_tokenizer=False, device=device)
                if model.speaker_params is not None:
                    rwav, rsr = read_wav(row["ref_audio"])
                    row["speaker_embedding"] = model.extract_speaker_embedding(
                        resample(rwav, rsr, 24000), 24000).tolist()
            out_rows.append(row)
        print(f"encoded {len(out_rows)}/{len(rows)}", file=sys.stderr)

    with open(args.output, "w", encoding="utf-8") as f:
        for row in out_rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
