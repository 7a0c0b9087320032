"""ctypes bindings for the native C++ host runtime (the PyTorch counterpart
of ``qwen_tts_tpu/io/native.py``).

The runtime's source is the port's own copy,
``qwen_tts_tpu_torch/csrc/host/qtts_runtime.cpp``: mmap + parallel page
prefetch of checkpoint shards, multithreaded bf16→f32, atomic WAV writes. At
first use it is built with ``g++`` into ``build/host/qtts_runtime-<hash>.so``
beside the package (the git-ignored tree where ``ops/cuda/build.py`` puts
the kernels; the hash covers the source and the flags). Nothing is written
outside ``build/``. ``available()`` keeps the JAX meaning: False when the
library cannot be built or loaded, and callers then use the pure-Python
implementations. Nothing on a device path calls this module.

``NativeMap.view`` hands back a read-only numpy ``uint8`` view of the
mapping, as the JAX module's does: the mapping is ``PROT_READ``, so a write
through a writable view would fault the process, and a numpy view is what
``bf16_to_f32`` takes. ``torch.from_numpy`` of a copy, or
``torch.frombuffer``, gives a tensor where one is wanted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "qtts_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-lpthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the built library lives: ``build/host/qtts_runtime-<hash>.so``."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LD_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"qtts_runtime-{digest[:16]}.so")


def build(out: str) -> bool:
    """Compile the runtime into ``out`` (written whole or not at all);
    whether it succeeded."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, SOURCE, *LD_FLAGS, "-o", tmp],
                       capture_output=True, check=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.qtts_open.restype = ctypes.c_void_p
        lib.qtts_open.argtypes = [ctypes.c_char_p]
        lib.qtts_data.restype = ctypes.c_void_p
        lib.qtts_data.argtypes = [ctypes.c_void_p]
        lib.qtts_size.restype = ctypes.c_uint64
        lib.qtts_size.argtypes = [ctypes.c_void_p]
        lib.qtts_header_len.restype = ctypes.c_uint64
        lib.qtts_header_len.argtypes = [ctypes.c_void_p]
        lib.qtts_close.argtypes = [ctypes.c_void_p]
        lib.qtts_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.qtts_bf16_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        ]
        lib.qtts_f32_to_bf16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64
        ]
        lib.qtts_write_wav.restype = ctypes.c_int
        lib.qtts_write_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


class NativeMap:
    """mmap'd safetensors file via the native runtime (zero-copy view)."""

    def __init__(self, path: str, prefetch_threads: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native runtime not available")
        self._lib = lib
        self._handle = lib.qtts_open(path.encode())
        if not self._handle:
            raise OSError(f"qtts_open failed for {path}")
        if prefetch_threads:
            lib.qtts_prefetch(self._handle, prefetch_threads)
        self.size = lib.qtts_size(self._handle)
        self.header_len = lib.qtts_header_len(self._handle)
        data_ptr = lib.qtts_data(self._handle)
        self._buf = np.ctypeslib.as_array(
            ctypes.cast(data_ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(self.size,),
        )
        self._buf.flags.writeable = False

    def header_bytes(self) -> bytes:
        return self._buf[8 : 8 + self.header_len].tobytes()

    def view(self, begin: int, end: int) -> np.ndarray:
        """Read-only uint8 view of [begin, end) within the data section."""
        start = 8 + self.header_len
        return self._buf[start + begin : start + end]

    def prefetch(self, n_threads: int = 8) -> None:
        self._lib.qtts_prefetch(self._handle, n_threads)

    def close(self):
        if self._handle:
            self._buf = None
            self._lib.qtts_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def bf16_to_f32(src: np.ndarray, n_threads: int = 8) -> np.ndarray:
    """Multithreaded bf16(uint16 view) → f32."""
    lib = get_lib()
    src = np.ascontiguousarray(src.view(np.uint16))
    out = np.empty(src.shape, np.float32)
    lib.qtts_bf16_to_f32(
        src.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        src.size, n_threads,
    )
    return out


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 24000) -> None:
    """16-bit PCM mono, atomically (tmp + rename). The runtime clips to
    [-1, 1] and rounds x * 32767 half away from zero; ``io/wav.py``, taken
    when the runtime is unavailable, truncates toward zero: the two differ
    by at most one step, as the JAX package's two writers do."""
    lib = get_lib()
    if lib is None:
        from qwen_tts_tpu_torch.io.wav import write_wav as py_write

        return py_write(path, samples, sample_rate)
    samples = np.ascontiguousarray(samples, np.float32)
    rc = lib.qtts_write_wav(
        path.encode(), samples.ctypes.data_as(ctypes.c_void_p),
        samples.size, sample_rate,
    )
    if rc != 0:
        raise OSError(f"qtts_write_wav failed with code {rc}")
