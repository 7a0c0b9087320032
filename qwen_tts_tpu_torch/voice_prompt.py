"""Voice files: save and load voice-clone prompts (the port's copy of
``qwen_tts_tpu/voice_prompt.py``).

Two containers, each readable by the JAX package too:

* ``.pt``: the reference demo's torch payload ``{"items": [item, ...]}``, each
  item a dict of ``ref_code`` (int tensor [T, G] or None),
  ``ref_spk_embedding`` (float tensor [D]), ``ref_text``, ``icl_mode`` and
  ``x_vector_only_mode``; loaded with ``weights_only=True``;
* ``.npz``: the same items flattened into numpy arrays (``n``,
  ``ref_code_{i}``, ``ref_spk_embedding_{i}``, ...).

In memory a prompt is a dict of lists, one entry per item, with the keys of
an item (``Qwen3TTSModel.create_voice_clone_prompt``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List

import numpy as np
import torch

_FIELDS = ("ref_code", "ref_spk_embedding", "ref_text", "icl_mode", "x_vector_only_mode")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _prompt_to_items(prompt: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Dict of lists → the reference's list of item dicts."""
    n = len(prompt["ref_spk_embedding"])

    def col(name, default):
        v = prompt.get(name)
        return v if v is not None else [default] * n

    items = []
    for i in range(n):
        spk = prompt["ref_spk_embedding"][i]
        if spk is None:
            raise ValueError(
                "ref_spk_embedding is required to save a voice-clone prompt "
                "(the speaker encoder was unavailable when it was created)")
        code = col("ref_code", None)[i]
        items.append({
            "ref_code": None if code is None else _to_numpy(code),
            "ref_spk_embedding": _to_numpy(spk),
            "ref_text": col("ref_text", None)[i],
            "icl_mode": bool(col("icl_mode", True)[i]),
            "x_vector_only_mode": bool(col("x_vector_only_mode", False)[i]),
        })
    return items


def _items_to_prompt(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    prompt: Dict[str, List] = {k: [] for k in _FIELDS}
    for d in items:
        if not isinstance(d, dict):
            raise ValueError("invalid voice file: item is not a dict")
        spk = d.get("ref_spk_embedding")
        if spk is None:
            raise ValueError("invalid voice file: missing ref_spk_embedding")
        code = d.get("ref_code")
        xvec_only = bool(d.get("x_vector_only_mode", False))
        prompt["ref_code"].append(None if code is None else _to_numpy(code).astype(np.int32))
        prompt["ref_spk_embedding"].append(_to_numpy(spk).astype(np.float32))
        rt = d.get("ref_text")
        prompt["ref_text"].append(None if rt is None else str(rt))
        prompt["icl_mode"].append(bool(d.get("icl_mode", not xvec_only)))
        prompt["x_vector_only_mode"].append(xvec_only)
    if not prompt["ref_spk_embedding"]:
        raise ValueError("invalid voice file: empty items")
    return prompt


def normalize_voice_clone_prompt(prompt) -> Dict[str, Any]:
    """Every prompt form ``generate_voice_clone`` takes (the dict of lists,
    one item as a flat dict, a dataclass or an object with the item's
    attributes, or a list of items) → the dict of lists."""
    if isinstance(prompt, dict) and "ref_spk_embedding" in prompt:
        v = prompt["ref_spk_embedding"]
        if v is None or isinstance(v, (list, tuple)):
            return prompt  # already a dict of lists
        return _items_to_prompt([prompt])  # one flat-dict item
    items = prompt if isinstance(prompt, (list, tuple)) else [prompt]

    def as_dict(it):
        if isinstance(it, dict):
            return it
        if dataclasses.is_dataclass(it):
            return dataclasses.asdict(it)
        return {k: getattr(it, k) for k in _FIELDS if hasattr(it, k)}

    return _items_to_prompt([as_dict(it) for it in items])


def save_voice_clone_prompt(prompt: Dict[str, Any], path: str) -> str:
    """Write a voice-clone prompt, atomically: ``.npz`` → the numpy
    container, anything else → the reference's torch payload."""
    items = _prompt_to_items(prompt)
    tmp = path + ".tmp"
    if path.endswith(".npz"):
        flat: Dict[str, np.ndarray] = {"n": np.int64(len(items))}
        for i, it in enumerate(items):
            if it["ref_code"] is not None:
                flat[f"ref_code_{i}"] = np.asarray(it["ref_code"], np.int32)
            flat[f"ref_spk_embedding_{i}"] = np.asarray(it["ref_spk_embedding"], np.float32)
            if it["ref_text"] is not None:
                flat[f"ref_text_{i}"] = np.str_(it["ref_text"])
            flat[f"icl_mode_{i}"] = np.bool_(it["icl_mode"])
            flat[f"x_vector_only_mode_{i}"] = np.bool_(it["x_vector_only_mode"])
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
    else:
        payload = {"items": [
            {**it,
             "ref_code": None if it["ref_code"] is None
             else torch.from_numpy(np.array(it["ref_code"], copy=True)),
             "ref_spk_embedding": torch.from_numpy(np.array(it["ref_spk_embedding"], copy=True))}
            for it in items]}
        torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_voice_clone_prompt(path: str) -> Dict[str, Any]:
    """Read a voice file written by ``save_voice_clone_prompt``, by the JAX
    package or by the reference demo → a prompt dict for
    ``generate_voice_clone``."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            items = [{
                "ref_code": z[f"ref_code_{i}"] if f"ref_code_{i}" in z else None,
                "ref_spk_embedding": z[f"ref_spk_embedding_{i}"],
                "ref_text": str(z[f"ref_text_{i}"]) if f"ref_text_{i}" in z else None,
                "icl_mode": bool(z[f"icl_mode_{i}"]),
                "x_vector_only_mode": bool(z[f"x_vector_only_mode_{i}"]),
            } for i in range(int(z["n"]))]
        return _items_to_prompt(items)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "items" not in payload:
        raise ValueError("invalid voice file: expected a dict with an 'items' key")
    if not isinstance(payload["items"], list):
        raise ValueError("invalid voice file: 'items' is not a list")
    return _items_to_prompt(payload["items"])
