"""The port's checkpoint export (``io/saver.py``) against the JAX package's:
the same named tensors for the same trees, and a finetuned checkpoint that
both packages' ``from_pretrained`` load to the same parameters, with the
speaker baked in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu.io.saver import export_talker_state as j_export
from qwen_tts_tpu.pipeline import Qwen3TTSModel as JModel
from qwen_tts_tpu_torch.io.loader import load_checkpoint as t_load
from qwen_tts_tpu_torch.io.saver import export_talker_state, save_finetuned_checkpoint
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel as TModel


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_saver_base"))
    make_checkpoint(d)
    return d


def test_export_gives_jax_keys_and_arrays(base):
    _, jt, js, _, _ = j_load(base, talker_dtype=jnp.float32)
    _, tt, ts, _, _ = t_load(base, talker_dtype=torch.float32, device="cpu")
    want = j_export(jt, js)
    got = export_talker_state(tt, ts)
    assert set(got) == set(want)
    for name, arr in want.items():
        t = got[name]
        assert t.device.type == "cpu" and t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)
    # bf16 trees export bf16 tensors of the same bits.
    _, tb, sb, _, _ = t_load(base, talker_dtype=torch.bfloat16, device="cpu")
    half = export_talker_state(tb, sb)
    assert all(t.dtype == torch.bfloat16 for t in half.values())
    np.testing.assert_array_equal(half["talker.codec_head.weight"].float().numpy(),
                                  got["talker.codec_head.weight"].to(torch.bfloat16).float().numpy())


def test_export_loads_in_both_packages_with_equal_params(base, tmp_path):
    cfg, tt, ts, _, _ = t_load(base, talker_dtype=torch.float32, device="cpu")
    # Move the weights, so that an export of the base's own file would show.
    tt = dict(tt, norm=tt["norm"] * 1.5)
    ts = dict(ts, lm_heads=ts["lm_heads"] + 0.25)
    spk = np.random.default_rng(1).standard_normal(cfg.talker.hidden_size).astype(np.float32)
    slot = cfg.talker.vocab_size - 2
    out = str(tmp_path / "ft")
    save_finetuned_checkpoint(base, out, tt, ts, speaker_name="myvoice",
                              speaker_embedding=spk, speaker_slot=slot)

    t_model = TModel.from_pretrained(out, talker_dtype=torch.float32, device="cpu",
                                     load_tokenizer=False)
    j_model = JModel.from_pretrained(out, talker_dtype=jnp.float32, load_tokenizer=False)
    for m in (t_model, j_model):
        assert m.get_supported_speakers() == ["myvoice"]
        assert m.cfg.tts_model_type == "custom_voice"
    assert t_model.speaker_params is None
    np.testing.assert_array_equal(t_model.talker_params["codec_embedding"][slot].numpy(), spk)
    emb = tt["codec_embedding"].clone()
    emb[slot] = torch.from_numpy(spk)
    np.testing.assert_array_equal(t_model.talker_params["codec_embedding"].numpy(), emb.numpy())
    np.testing.assert_array_equal(t_model.talker_params["norm"].numpy(), tt["norm"].numpy())
    np.testing.assert_array_equal(t_model.subtalker_params["lm_heads"].numpy(),
                                  ts["lm_heads"].numpy())
    for tree_t, tree_j in ((t_model.talker_params, j_model.talker_params),
                           (t_model.subtalker_params, j_model.subtalker_params)):
        for k, v in tree_t.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(vv.numpy(), np.asarray(tree_j[k][kk]),
                                                  err_msg=f"{k}/{kk}")
            else:
                np.testing.assert_array_equal(v.numpy(), np.asarray(tree_j[k]), err_msg=k)
    # The codec came across with the copied directory.
    assert t_model.codec_params is not None and j_model.codec_params is not None
