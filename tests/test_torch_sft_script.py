"""The port's SFT and data-prep entry points on the CPU
(``qwen_tts_tpu_torch/training/sft_12hz.py`` and ``prepare_data.py``), the
workflow of ``tests/test_sft_script_e2e.py`` and
``tests/test_prepare_data_script.py``: JSONL → train → export → the
exported checkpoint speaks the new voice; the first step's loss is JAX's
``sft_loss`` on the same first batch; the prepared rows hold the codes of
JAX's ``scripts/prepare_data.py``."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixture import make_checkpoint
from torch_port_fixtures import clone_checkpoint, one_torch_thread  # noqa: F401
from qwen_tts_tpu.io.loader import load_checkpoint as j_load
from qwen_tts_tpu.io.wav import write_wav
from qwen_tts_tpu.training import data as j_data
from qwen_tts_tpu.training import sft as j_sft
from qwen_tts_tpu_torch.io.wav import read_wav
from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
from qwen_tts_tpu_torch.training import prepare_data, sft_12hz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TinyTokenizer:
    """Text to ids inside the tiny text vocab."""

    def __call__(self, text):
        return {"input_ids": [1, 2, 3] + [10 + (ord(c) % 40) for c in text[:6]] + [4, 5]}


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_sft_base"))
    return d, make_checkpoint(d)


def _write_rows(path, cfg, n=3):
    rng = np.random.default_rng(0)
    g = cfg.talker.num_code_groups
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "text_ids": [1, 2, 3] + [10 + i, 11, 12 + i],
                "audio_codes": rng.integers(0, cfg.talker.vocab_size // 2, (4 + i, g)).tolist(),
                "speaker_embedding": rng.standard_normal(cfg.talker.hidden_size).round(4).tolist(),
            }) + "\n")


def test_sft_cli_trains_exports_and_speaks(base_ckpt, tmp_path, capsys):
    base_dir, cfg = base_ckpt
    data = str(tmp_path / "train.jsonl")
    _write_rows(data, cfg)
    out = tmp_path / "out"
    steps = []
    args = sft_12hz.parse_args(["--cpu", "--model-path", base_dir, "--data", data,
                                "--output-model-path", str(out), "--speaker-name", "myvoice",
                                "--num-epochs", "1", "--batch-size", "2", "--lr", "1e-4"])
    assert sft_12hz.train(args, on_step=lambda *a: steps.append(a)) == 0
    printed = capsys.readouterr().out
    assert "3 training examples" in printed and "epoch 0 | step 0 | loss" in printed
    assert "saved" in printed and "saved train state" in printed
    assert [s[0] for s in steps] == [0, 1]

    # Step 0's loss is JAX's sft_loss on the same first batch (the epoch's
    # permutation, np.random.default_rng(0)).
    rows = [json.loads(line) for line in open(data)]
    first = np.random.default_rng(0).permutation(len(rows))[:2]
    jcfg, jt, js, _, _ = j_load(base_dir, talker_dtype=jnp.float32)
    batch = j_data.collate([j_data.SFTExample(
        text_ids=np.asarray(rows[i]["text_ids"], np.int64),
        audio_codes=np.asarray(rows[i]["audio_codes"], np.int64),
        speaker_embedding=np.asarray(rows[i]["speaker_embedding"], np.float32))
        for i in first], jcfg, jt, js)
    j_loss, _ = jax.jit(lambda p, b: j_sft.sft_loss(p, jcfg.talker, b))(
        {"talker": jt, "subtalker": js}, batch)
    np.testing.assert_allclose(float(steps[0][2]), float(j_loss), rtol=1e-5)

    ft_dir = str(out / "checkpoint-epoch-0")
    assert (out / "train_state" / "meta.json").exists()
    assert json.load(open(out / "train_state" / "meta.json"))["step"] == 2
    model = Qwen3TTSModel.from_pretrained(ft_dir, talker_dtype=torch.float32, device="cpu",
                                          load_tokenizer=False)
    assert model.get_supported_speakers() == ["myvoice"]
    slot = min(3000, cfg.talker.vocab_size - 1)
    np.testing.assert_array_equal(model.talker_params["codec_embedding"][slot].numpy(),
                                  np.asarray(rows[0]["speaker_embedding"], np.float32))
    model.tokenizer = TinyTokenizer()
    wavs, sr = model.generate_custom_voice("hello", "myvoice", "english", max_new_tokens=3,
                                           do_sample=False, subtalker_dosample=False)
    assert sr == 24000
    assert wavs[0].shape[0] > 0 and np.isfinite(wavs[0]).all()

    # --resume from the snapshot: the epoch is done, nothing left to train.
    more = sft_12hz.parse_args(["--cpu", "--model-path", base_dir, "--data", data,
                                "--output-model-path", str(out), "--speaker-name", "myvoice",
                                "--num-epochs", "1", "--resume", str(out / "train_state")])
    assert sft_12hz.train(more, on_step=lambda *a: steps.append(a)) == 0
    assert "resumed from" in capsys.readouterr().out and len(steps) == 2


def test_sft_cli_runs_as_a_module_and_asks_for_a_card(base_ckpt, tmp_path):
    """``python -m`` reaches ``main``; without ``--cpu`` and without a card
    it refuses rather than training on the CPU."""
    base_dir, cfg = base_ckpt
    data = str(tmp_path / "train.jsonl")
    _write_rows(data, cfg, n=1)
    run = subprocess.run(
        [sys.executable, "-m", "qwen_tts_tpu_torch.training.sft_12hz", "--model-path",
         base_dir, "--data", data, "--output-model-path", str(tmp_path / "o"),
         "--speaker-name", "v"], cwd=REPO, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    assert run.returncode != 0 and "device='cpu'" in run.stderr
    assert not (tmp_path / "o").exists()


def test_prepare_data_writes_jax_codes(tmp_path_factory, tmp_path):
    """The port's rows hold JAX's codes; the port's first row also names a
    reference clip and gains that clip's x-vector (the port's x-vectors
    are held against JAX's in tests/test_torch_speaker.py)."""
    ckpt = clone_checkpoint(tmp_path_factory)
    rng = np.random.default_rng(0)
    rows, clips = [], []
    for i, n in enumerate((4800, 7200, 3000)):
        wav = str(tmp_path / f"a{i}.wav")
        clips.append((0.1 * rng.standard_normal(n)).astype(np.float32))
        write_wav(wav, clips[-1], 24000)
        rows.append({"audio": wav, "text": f"utterance {i}"})
    src, src_ref = str(tmp_path / "in.jsonl"), str(tmp_path / "in_ref.jsonl")
    for path, first in ((src, rows[0]), (src_ref, dict(rows[0], ref_audio=rows[0]["audio"]))):
        with open(path, "w") as f:
            for row in [first] + rows[1:]:
                f.write(json.dumps(row) + "\n")

    t_out, j_out = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert prepare_data.main(["--cpu", "--model-path", ckpt, "--input", src_ref,
                              "--output", t_out, "--batch-size", "2"]) == 0
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data", os.path.join(REPO, "scripts", "prepare_data.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    argv = sys.argv
    sys.argv = ["prepare_data.py", "--cpu", "--model-path", ckpt, "--input", src,
                "--output", j_out, "--batch-size", "2"]
    try:
        assert jax_script.main() == 0
    finally:
        sys.argv = argv

    got = [json.loads(line) for line in open(t_out)]
    want = [json.loads(line) for line in open(j_out)]
    assert len(got) == len(want) == 3
    distinct = set()
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(np.asarray(g["audio_codes"]), np.asarray(w["audio_codes"]))
        distinct |= set(np.asarray(g["audio_codes"]).reshape(-1).tolist())
    assert len(distinct) > 4  # random codebooks: the codes say something
    assert all("speaker_embedding" not in r for r in got[1:] + want)
    model = Qwen3TTSModel.from_pretrained(ckpt, device="cpu", load_tokenizer=False)
    np.testing.assert_array_equal(np.asarray(got[0]["speaker_embedding"], np.float32),
                                  model.extract_speaker_embedding(
                                      read_wav(rows[0]["audio"])[0], 24000))
