"""Reference-audio input: loading, normalization, resampling (the port's copy
of ``qwen_tts_tpu/audio.py``, host-side numpy and scipy).

Accepted inputs: a string (WAV path, http(s) URL, base64 or data-URI audio),
an ``(np.ndarray, sr)`` tuple, or a list of those, normalized to mono float32
plus the original sample rate.

Resampling is polyphase windowed-sinc (``scipy.signal.resample_poly`` with a
64-zero-crossing Kaiser filter), not linear interpolation: the reference audio
feeds both the codec encoder and the speaker x-vector. Where ``scipy.signal``
cannot be imported, a numpy convolution with the same filter
(``_resample_poly_np``) takes its place, as in the JAX package.
"""

from __future__ import annotations

import base64
import io
import math
import os
import re
import urllib.request
from typing import List, Sequence, Tuple, Union
from urllib.parse import urlparse

import numpy as np

from qwen_tts_tpu_torch.io.wav import read_wav

AudioLike = Union[str, np.ndarray, Tuple[np.ndarray, int]]


def _design_kaiser(up: int, down: int, num_zeros: int = 64,
                   beta: float = 14.769656459379492,
                   rolloff: float = 0.9475) -> np.ndarray:
    """64-zero-crossing Kaiser-windowed sinc at the upsampled rate, cutoff
    ``rolloff`` x min(sr_in, sr_out) / 2."""
    c = rolloff * min(1.0, up / down) / up  # fraction of the upsampled Nyquist
    half = int(math.ceil(num_zeros / c))
    n = np.arange(-half, half + 1)
    return c * np.sinc(c * n) * np.kaiser(2 * half + 1, beta)


def _scipy_resample_poly():
    """``scipy.signal.resample_poly``, or None where scipy.signal cannot be
    imported."""
    try:
        from scipy.signal import resample_poly
    except ImportError:
        return None
    return resample_poly


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling (Kaiser beta 14.77, 64 zero
    crossings), float32 out: scipy's ``resample_poly`` where scipy.signal can
    be imported, else ``_resample_poly_np`` with the same filter."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    h = _design_kaiser(up, down)
    resample_poly = _scipy_resample_poly()
    if resample_poly is None:
        return _resample_poly_np(np.asarray(wav, np.float64), up, down, h)
    return resample_poly(np.asarray(wav, np.float64), up, down, window=h).astype(np.float32)


def _resample_poly_np(x: np.ndarray, up: int, down: int, h: np.ndarray) -> np.ndarray:
    """``resample_poly`` in numpy (float64 in, float32 out): zero-stuff by
    ``up``, convolve with ``h`` (centred), keep every ``down``-th sample,
    the right edge padded with zeros to ceil(n * up / down) samples.
    O(n * up * taps), for clip-length reference audio."""
    taps = h.shape[0]
    x_up = np.zeros(x.shape[0] * up)
    x_up[::up] = x
    y_up = np.convolve(x_up, h)[taps // 2: taps // 2 + x_up.shape[0]]
    n_out = -(-x.shape[0] * up // down)
    idx = np.arange(n_out) * down
    y = up * y_up[idx[idx < y_up.shape[0]]]
    if y.shape[0] < n_out:
        y = np.pad(y, (0, n_out - y.shape[0]))
    return y.astype(np.float32)


def _is_url(s: str) -> bool:
    try:
        u = urlparse(s)
    except ValueError:
        return False
    return u.scheme in ("http", "https") and bool(u.netloc)


def _is_probably_base64(s: str) -> bool:
    """A data URI, a long blob without path separators, or a long blob of the
    base64 alphabet (which holds '/') that names no existing file."""
    if s.startswith("data:audio"):
        return True
    if ("/" not in s and "\\" not in s) and len(s) > 256:
        return True
    if len(s) > 256 and not os.path.exists(s):
        return re.fullmatch(r"[A-Za-z0-9+/\s]+={0,2}\s*", s) is not None
    return False


def load_audio(src: str) -> Tuple[np.ndarray, int]:
    """A WAV path, http(s) URL, or base64/data-URI string → (mono float32, sr)."""
    if _is_url(src):
        with urllib.request.urlopen(src) as resp:
            return read_wav(io.BytesIO(resp.read()))
    if _is_probably_base64(src):
        b64 = src.split(",", 1)[1] if src.strip().startswith("data:") else src
        return read_wav(io.BytesIO(base64.b64decode(b64)))
    return read_wav(src)


def normalize_audio_inputs(
    audios: Union[AudioLike, Sequence[AudioLike]],
) -> List[Tuple[np.ndarray, int]]:
    """Normalize to a list of (mono float32 waveform, original sr).

    Accepted per item: str (path/URL/base64), (np.ndarray, sr). A bare
    ndarray is refused: the sample rate is required."""
    items = list(audios) if isinstance(audios, (list, tuple)) and not (
        len(audios) == 2
        and isinstance(audios[0], np.ndarray)
        and isinstance(audios[1], (int, np.integer))
    ) else [audios]
    out: List[Tuple[np.ndarray, int]] = []
    for a in items:
        if isinstance(a, str):
            wav, sr = load_audio(a)
        elif (isinstance(a, (tuple, list)) and len(a) == 2
              and isinstance(a[0], np.ndarray)):
            wav, sr = np.asarray(a[0], np.float32), int(a[1])
        elif isinstance(a, np.ndarray):
            raise ValueError("For numpy waveform input, pass a tuple (audio, sr).")
        else:
            raise TypeError(f"Unsupported audio input type: {type(a)}")
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        out.append((wav.astype(np.float32), sr))
    return out
