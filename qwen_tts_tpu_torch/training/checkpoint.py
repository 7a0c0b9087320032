"""Train-state snapshot and resume (PyTorch counterpart of
``qwen_tts_tpu/training/checkpoint.py``).

The full train state (params, optimizer state, step and epoch counters)
goes to ``<dir>/state.step<N>/`` as two safetensors files,
``params.safetensors`` and ``opt_state.safetensors``, each leaf under its
path in the tree (``talker/trunk/wq``, ``mu/subtalker/norm``, ``count``),
plus ``<dir>/meta.json`` ({step, epoch, state_dir, ...}). The pair commits
at one point: each snapshot is written to a fresh step-named directory, and
only the ``os.replace`` of ``meta.json`` makes it current, so a crash
anywhere before leaves ``meta.json`` naming the previous snapshot, untouched.
Superseded snapshots are pruned after the commit. Nothing is pickled.

``load_train_state`` restores into the structure of freshly built state:
the params tree the caller passes and ``optimizer.init`` of it. Every leaf's
key, shape and dtype must match, and the files may hold no other leaf; any
difference raises ``ValueError``. The values restored are the bits saved,
so a resumed run continues as the uninterrupted one would.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from qwen_tts_tpu_torch.io.safetensors import SafeTensorsFile, save_file

def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts and lists of tensors → {"a/b/0/c": tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _restore(template, loaded: Dict[str, torch.Tensor], what: str, into: bool,
             prefix: str = ""):
    """``template``'s structure holding the loaded bits: in the template's
    own leaves (``into``: a freshly built state) or in new tensors on their
    devices."""
    if isinstance(template, dict):
        return {k: _restore(v, loaded, what, into, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _restore(v, loaded, what, into, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    src = loaded[prefix]
    if src.shape != template.shape or src.dtype != template.dtype:
        raise ValueError(f"{what} {prefix!r}: the snapshot holds {src.dtype} "
                         f"{tuple(src.shape)}, the fresh state {template.dtype} "
                         f"{tuple(template.shape)}")
    return (template if into else torch.empty_like(template)).copy_(src)


def save_train_state(ckpt_dir: str, params: Any, opt_state: Any, *, step: int,
                     epoch: int = 0, extra: Optional[Dict[str, Any]] = None) -> str:
    """Snapshot the full train state; returns the checkpoint directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    state_name = f"state.step{int(step)}"
    state_dir = os.path.join(ckpt_dir, state_name)
    shutil.rmtree(state_dir, ignore_errors=True)  # a snapshot of this step left uncommitted
    os.makedirs(state_dir)
    for name, tree in (("params", params), ("opt_state", opt_state)):
        save_file(flatten(tree), os.path.join(state_dir, name + ".safetensors"))
    meta = {"step": int(step), "epoch": int(epoch), "state_dir": state_name}
    if extra:
        meta.update(extra)
    tmp = os.path.join(ckpt_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(ckpt_dir, "meta.json"))  # the commit point
    # Prune superseded snapshots (never part of the commit).
    for name in os.listdir(ckpt_dir):
        if name != state_name and name.startswith("state.step"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    return ckpt_dir


def load_train_state(ckpt_dir: str, params_template: Any, optimizer
                     ) -> Tuple[Any, Any, Dict[str, Any]]:
    """(params, opt_state, meta) from :func:`save_train_state`, into the
    structure, shapes, dtypes and devices of ``params_template`` and
    ``optimizer.init(params_template)``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    state_dir = os.path.join(ckpt_dir, meta["state_dir"])
    restored = []
    for name, template, into in (("params", params_template, False),
                                 ("opt_state", optimizer.init(params_template), True)):
        st = SafeTensorsFile(os.path.join(state_dir, name + ".safetensors"))
        try:
            want, have = set(flatten(template)), set(st.keys())
            if want != have:
                raise ValueError(
                    f"{name}: the snapshot's leaves differ from the fresh state's "
                    f"(only in the snapshot: {sorted(have - want)[:5]}; only in the "
                    f"fresh state: {sorted(want - have)[:5]})")
            restored.append(_restore(template, {k: st.get(k) for k in have}, name, into))
        finally:
            st.close()
    return restored[0], restored[1], meta
