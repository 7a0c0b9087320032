"""Checkpoint export: parameter trees → reference-format safetensors (PyTorch
counterpart of ``qwen_tts_tpu/io/saver.py``).

Reverses the loader's layout (``io/loader.py``: ``load_talker`` and
``load_subtalker``): ``[in, out]`` weights back to ``[out, in]``, stacked
layers and group tables back to one tensor each. A finetuned checkpoint
written here loads in either package and in any reference-compatible
runtime. Tensors keep their dtype (f32 master weights stay f32, bf16 stays
bf16) and are written by the port's own ``io/safetensors.py::save_file``.
Under tp the export gathers the split leaves (every rank calls it) and
global rank 0 writes the files a single device writes.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from qwen_tts_tpu_torch.io.safetensors import save_file
from qwen_tts_tpu_torch.parallel.multihost import writes_files


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu")


def _lin(w: torch.Tensor) -> torch.Tensor:
    """[in, out] → torch's [out, in]."""
    return _host(w).t().contiguous()


def export_talker_state(talker: dict, subtalker: dict) -> Dict[str, torch.Tensor]:
    """The talker and sub-talker trees as the checkpoint's named tensors, on
    the host."""
    t: Dict[str, torch.Tensor] = {
        "talker.model.codec_embedding.weight": _host(talker["codec_embedding"]),
        "talker.model.text_embedding.weight": _host(talker["text_embedding"]),
        "talker.text_projection.linear_fc1.weight": _lin(talker["text_proj_fc1"]),
        "talker.text_projection.linear_fc1.bias": _host(talker["text_proj_fc1_b"]),
        "talker.text_projection.linear_fc2.weight": _lin(talker["text_proj_fc2"]),
        "talker.text_projection.linear_fc2.bias": _host(talker["text_proj_fc2_b"]),
        "talker.model.norm.weight": _host(talker["norm"]),
        "talker.codec_head.weight": _lin(talker["codec_head"]),
    }

    def dump_trunk(prefix: str, trunk: dict):
        for l in range(trunk["wq"].shape[0]):
            p = f"{prefix}.layers.{l}."
            for key, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                              ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                              ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                              ("down", "mlp.down_proj")):
                t[p + name + ".weight"] = _lin(trunk[key][l])
            for key, name in (("q_norm", "self_attn.q_norm"), ("k_norm", "self_attn.k_norm"),
                              ("input_norm", "input_layernorm"),
                              ("post_attn_norm", "post_attention_layernorm")):
                t[p + name + ".weight"] = _host(trunk[key][l])

    dump_trunk("talker.model", talker["trunk"])
    dump_trunk("talker.code_predictor.model", subtalker["trunk"])
    t["talker.code_predictor.model.norm.weight"] = _host(subtalker["norm"])
    for i in range(subtalker["embeds"].shape[0]):
        t[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = _host(
            subtalker["embeds"][i])
        t[f"talker.code_predictor.lm_head.{i}.weight"] = _lin(subtalker["lm_heads"][i])
    if "input_proj" in subtalker:
        t["talker.code_predictor.small_to_mtp_projection.weight"] = _lin(subtalker["input_proj"])
        t["talker.code_predictor.small_to_mtp_projection.bias"] = _host(
            subtalker["input_proj_b"])
    return t


def save_finetuned_checkpoint(
    base_dir: str,
    output_dir: str,
    talker: dict,
    subtalker: dict,
    *,
    speaker_name: str,
    speaker_embedding: Optional[np.ndarray] = None,
    speaker_slot: int = 3000,
    sharding=None,
) -> None:
    """The reference SFT's export: the base checkpoint's directory copied,
    its config patched (``custom_voice``, the speaker's slot), the speaker
    embedding baked into ``codec_embedding[slot]``, one
    ``model.safetensors``. The base's top-level safetensors files are not
    copied: the export replaces them (the JAX package copies and then
    deletes them; the directory ends the same). ``sharding``
    (``ParamSharding``): the trees are a rank's shards; every rank calls
    this and global rank 0 writes."""
    if sharding is not None:
        full = sharding.gather_tree({"talker": talker, "subtalker": subtalker})
        talker, subtalker = full["talker"], full["subtalker"]
    if not writes_files():
        return

    def skip_weights(directory, names):
        if os.path.abspath(directory) != os.path.abspath(base_dir):
            return []
        return [n for n in names if n.endswith((".safetensors", ".safetensors.index.json"))]

    os.makedirs(output_dir, exist_ok=True)
    shutil.copytree(base_dir, output_dir, dirs_exist_ok=True, ignore=skip_weights)

    cfg_path = os.path.join(output_dir, "config.json")
    with open(cfg_path, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["tts_model_type"] = "custom_voice"
    talker_cfg = cfg.get("talker_config", {})
    talker_cfg["spk_id"] = {speaker_name: speaker_slot}
    talker_cfg["spk_is_dialect"] = {speaker_name: False}
    cfg["talker_config"] = talker_cfg
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, ensure_ascii=False)

    state = export_talker_state(talker, subtalker)
    if speaker_embedding is not None:
        emb = state["talker.model.codec_embedding.weight"].clone()
        emb[speaker_slot] = torch.as_tensor(np.asarray(speaker_embedding), dtype=emb.dtype)
        state["talker.model.codec_embedding.weight"] = emb

    # Drop any stale weights of an earlier export; write a single shard.
    for f in os.listdir(output_dir):
        if f.endswith((".safetensors", ".safetensors.index.json")):
            os.unlink(os.path.join(output_dir, f))
    save_file(state, os.path.join(output_dir, "model.safetensors"))
