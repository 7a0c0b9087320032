"""SafeTensors reading (multi-shard, mmap-backed) and a small writer.

The port's own reader: tensors come out as torch tensors over an ``mmap`` of
the file, without a copy until the caller converts or moves them. bf16 is read
with ``torch.frombuffer(..., dtype=torch.bfloat16)``, so neither ``ml_dtypes``
nor the ``safetensors`` package is needed. Shard discovery follows the JAX
package's reader: ``*.safetensors.index.json`` when present, else every
``*.safetensors`` file of the directory, sorted.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, List, Mapping, Tuple

import torch

_DTYPES: Mapping[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafeTensorsFile:
    """One mmap'd .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            # Copy-on-write mapping: writable, so torch.frombuffer takes it
            # without a warning; the file itself is never written.
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        (header_len,) = struct.unpack("<Q", self._mm[:8])
        header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        self._data_start = 8 + header_len
        self.tensors: Dict[str, dict] = {
            k: v for k, v in header.items() if k != "__metadata__"
        }

    def keys(self) -> Iterable[str]:
        return self.tensors.keys()

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        """(dtype string, shape) of ``name`` from the header; the data is
        not touched."""
        t = self.tensors[name]
        return t["dtype"], tuple(t["shape"])

    def get(self, name: str) -> torch.Tensor:
        """A CPU tensor over the mapping (no copy)."""
        t = self.tensors[name]
        dtype = _DTYPES[t["dtype"]]
        begin, end = t["data_offsets"]
        shape = tuple(t["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(
            self._mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
            offset=self._data_start + begin,
        )
        return flat.reshape(shape)

    def close(self):
        """Release the mapping. Tensors still viewing it keep it alive."""
        try:
            self._mm.close()
        except BufferError:
            pass


class MultiSafeTensors:
    """All shards in a directory, with name → shard resolution."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        index_path = None
        for fname in sorted(os.listdir(model_dir)):
            if fname.endswith(".safetensors.index.json"):
                index_path = os.path.join(model_dir, fname)
                break
        shard_names: List[str]
        if index_path:
            with open(index_path, encoding="utf-8") as f:
                index = json.load(f)
            shard_names = sorted(set(index["weight_map"].values()))
        else:
            shard_names = sorted(
                f for f in os.listdir(model_dir) if f.endswith(".safetensors")
            )
        if not shard_names:
            raise FileNotFoundError(f"no .safetensors shards in {model_dir}")
        self.shards = [
            SafeTensorsFile(os.path.join(model_dir, s)) for s in shard_names
        ]
        self._index: Dict[str, SafeTensorsFile] = {}
        for shard in self.shards:
            for name in shard.keys():
                self._index[name] = shard

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def keys(self) -> Iterable[str]:
        return self._index.keys()

    def _shard(self, name: str) -> SafeTensorsFile:
        if name not in self._index:
            raise KeyError(f"tensor {name!r} not found in {self.model_dir}")
        return self._index[name]

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        """(dtype string, shape) of ``name`` from its shard's header."""
        return self._shard(name).info(name)

    def get(self, name: str) -> torch.Tensor:
        return self._shard(name).get(name)

    def get_f32(self, name: str) -> torch.Tensor:
        return self.get(name).float()

    def close(self):
        for s in self.shards:
            s.close()


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as one .safetensors file (header, then the raw
    little-endian bytes of each tensor in order). Tensors on another device
    come to the host one at a time, so the host holds one copy at most."""
    header: Dict[str, dict] = {}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
