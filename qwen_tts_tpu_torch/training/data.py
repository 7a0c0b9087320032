"""SFT data: JSONL examples → fused dual-track training batches (PyTorch
counterpart of ``qwen_tts_tpu/training/data.py``, the same layout position
for position):

  pos 0..2   role text ids                       (text track only)
  pos 3..6   tts_pad x4 on text; [nothink, think_bos, think_eos, <spk>] codec
  pos 7      tts_bos  +  codec_pad
  pos 8..    text ids[3:]  +  codec_pad
  ...        tts_eos  +  codec_pad
  ...        tts_pad  +  codec_bos
  ...        tts_pad  +  codec frames (sum of the group embeddings)  ← supervised
  last       codec EOS label

Position 6 carries the example's speaker embedding. Labels are the next
position's codebook-0 ids (-100 elsewhere) and a final EOS label; the
sub-talker pairs position t's hidden state with frame t+1's group ids.

The embedding sums run under ``torch.no_grad()`` on the parameters' device:
the inputs are data for the train step, as in JAX, where they are computed
outside the differentiated function.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from qwen_tts_tpu_torch.config import TTSConfig
from qwen_tts_tpu_torch.models import talker as talker_mod
from qwen_tts_tpu_torch.training.sft import SFTBatch


@dataclasses.dataclass
class SFTExample:
    text_ids: np.ndarray     # [T_text] chat-template ids, the trailing 5
                             # template ids already trimmed
    audio_codes: np.ndarray  # [T_frames, G] codec ids
    speaker_embedding: Optional[np.ndarray] = None  # [D] x-vector (else zeros)


def load_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def collate(examples: Sequence[SFTExample], cfg: TTSConfig, talker_params: dict,
            st_params: dict) -> SFTBatch:
    """An ``SFTBatch`` on the parameters' device, the inputs in f32."""
    tk = cfg.talker
    g = tk.num_code_groups
    d = tk.hidden_size
    lengths = [8 + (e.text_ids.shape[0] - 3) + e.audio_codes.shape[0] + 1 for e in examples]
    # The reference's width: max(text_len + codes_len) + 8; lengths[i] is
    # text_len + codes_len + 6, so + 2 lands there.
    t_max = max(lengths) + 2
    b = len(examples)

    text_ids = np.zeros((b, t_max), np.int64)
    codec_ids0 = np.zeros((b, t_max), np.int64)
    text_mask = np.zeros((b, t_max, 1), np.float32)
    codec_mask_emb = np.zeros((b, t_max, 1), np.float32)
    frame_codes = np.zeros((b, t_max, g), np.int64)
    frame_mask = np.zeros((b, t_max), bool)
    attention = np.zeros((b, t_max), bool)
    labels = np.full((b, t_max), -100, np.int64)
    spk = np.zeros((b, d), np.float32)

    for i, e in enumerate(examples):
        tids = np.asarray(e.text_ids, np.int64)
        codes = np.asarray(e.audio_codes, np.int64)[:, :g]
        tl = tids.shape[0]
        cl = codes.shape[0]

        # text track
        text_ids[i, :3] = tids[:3]
        text_ids[i, 3:7] = cfg.tts_pad_token_id
        text_ids[i, 7] = cfg.tts_bos_token_id
        text_ids[i, 8 : 8 + tl - 3] = tids[3:]
        text_ids[i, 8 + tl - 3] = cfg.tts_eos_token_id
        text_ids[i, 8 + tl - 2 : 8 + tl + cl] = cfg.tts_pad_token_id
        text_mask[i, : 8 + tl + cl] = 1.0

        # codec track
        codec_ids0[i, 3:8] = [tk.codec_nothink_id, tk.codec_think_bos_id,
                              tk.codec_think_eos_id, 0, tk.codec_pad_id]
        codec_ids0[i, 8 : 8 + tl - 2] = tk.codec_pad_id
        codec_ids0[i, 8 + tl - 2] = tk.codec_bos_id
        codec_ids0[i, 8 + tl - 1 : 8 + tl - 1 + cl] = codes[:, 0]
        # The last attended position carries codec EOS as input; its output
        # is not supervised.
        codec_ids0[i, 8 + tl - 1 + cl] = tk.codec_eos_token_id
        codec_mask_emb[i, 3 : 8 + tl + cl] = 1.0
        codec_mask_emb[i, 6] = 0.0  # speaker-embedding slot

        labels[i, 8 + tl - 1 : 8 + tl - 1 + cl] = codes[:, 0]
        labels[i, 8 + tl - 1 + cl] = tk.codec_eos_token_id

        frame_codes[i, 8 + tl - 1 : 8 + tl - 1 + cl] = codes
        frame_mask[i, 8 + tl - 1 : 8 + tl - 1 + cl] = True
        attention[i, : 8 + tl + cl] = True
        if e.speaker_embedding is not None:
            spk[i] = e.speaker_embedding

    device = talker_params["norm"].device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    # Fused embeddings: text + codec-0 + the sum of the group embeddings.
    with torch.no_grad():
        inputs = talker_mod.embed_text(talker_params, put(text_ids)).float() * put(text_mask)
        codec_emb = talker_mod.embed_codec(talker_params, put(codec_ids0)).float() * put(
            codec_mask_emb)
        codec_emb[:, 6, :] = put(spk)
        inputs = inputs + codec_emb
        fm = put(frame_mask)[..., None].float()
        codes_dev = put(frame_codes)
        for gi in range(1, g):
            inputs = inputs + st_params["embeds"][gi - 1][codes_dev[:, :, gi]].float() * fm

    # Shift: the model sees positions [:-1] and predicts labels [1:]; the
    # sub-talker pairs position t's hidden state with frame t+1's groups.
    return SFTBatch(
        inputs_embeds=inputs[:, :-1],
        pad_mask=put(attention[:, :-1]),
        codec0_labels=put(labels[:, 1:]),
        group_labels=codes_dev[:, 1:],
        frame_mask=put(frame_mask[:, 1:]),
    )


def examples_from_jsonl(path: str, tokenizer, build_assistant_text) -> List[SFTExample]:
    """Rows with "text", "audio_codes" (from ``prepare_data``) and an
    optional "speaker_embedding". A row may carry pre-tokenized "text_ids"
    (already template-trimmed) instead of "text": no tokenizer needed."""
    out = []
    for row in load_jsonl(path):
        if "text_ids" in row:
            ids = np.asarray(row["text_ids"], np.int64)
        else:
            if tokenizer is None:
                raise ValueError("row has no 'text_ids' and no tokenizer is available")
            ids = np.asarray(tokenizer(build_assistant_text(row["text"]))["input_ids"],
                             np.int64)[:-5]
        out.append(SFTExample(
            text_ids=ids,
            audio_codes=np.asarray(row["audio_codes"], np.int64),
            speaker_embedding=(np.asarray(row["speaker_embedding"], np.float32)
                               if "speaker_embedding" in row else None),
        ))
    return out
