"""WAV file IO (the port's copy of ``qwen_tts_tpu/io/wav.py``): a 16-bit PCM
writer that replaces the target atomically, and a reader for 8/16/32-bit PCM.
Standard library ``wave`` only."""

from __future__ import annotations

import os
import tempfile
import wave
from typing import Tuple

import numpy as np


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 24000) -> None:
    """Write mono float32 samples in [-1, 1] as 16-bit PCM, atomically."""
    samples = np.asarray(samples, np.float32).reshape(-1)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".wav.tmp", dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            with wave.open(f, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes(pcm.tobytes())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path or binary file-like) to mono float32 in [-1, 1].
    Returns (samples, rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate
