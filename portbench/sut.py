"""The system under test, made from the seed: the port's model over the
benchmark's random weights (``weights.py``), drawn on the device (no
checkpoint on disk, no text tokenizer: the traffic gives token ids)."""

from __future__ import annotations

import torch

import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tts_config(cfg: dict):
    from qwen_tts_tpu_torch.config import TTSConfig

    return TTSConfig.from_dict(cfg, codec=cfg["speech_tokenizer"])


def cell_weights(ctx) -> dict:
    """The weights of a run's cell, from its seed: the same tensors each
    time they are drawn (the program's before the window, the reference's
    after it)."""
    return weights.draw(ctx.cfg, ctx.seed, ctx.device, DTYPES[ctx.mix["talker_dtype"]],
                        DTYPES[ctx.mix["codec_dtype"]])


def model(tts, w: dict, int8: bool):
    """``Qwen3TTSModel`` over the weights; with ``int8`` the server's serving
    mode (int8 talker and sub-talker, int8 KV cache). The weight dicts passed
    in are left as they are (the serving mode makes new ones)."""
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel

    m = Qwen3TTSModel(tts, w["talker"], w["subtalker"], w["codec"])
    if int8:
        m.quantize_for_serving(talker=True, kv=True)
    return m


def release(m) -> None:
    """Drop the captured programs on the model's trees and free the cache."""
    from qwen_tts_tpu_torch import graphs

    graphs.drop(m.talker_params, m.subtalker_params, m.codec_params)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def prompt_len(cfg: dict) -> int:
    """Real positions of a custom-voice prompt with a speaker and a language:
    the role header (3), the codec prefix less codec_bos (think, think_bos,
    language, think_eos, speaker, pad) and the first text token."""
    return 3 + 6 + 1
