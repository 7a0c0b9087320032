"""The PyTorch port stands alone: importing every module pulls in neither jax
nor anything of the JAX package, and its entry points refuse to fall back to
the CPU when no device is named and no card is present."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import qwen_tts_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import qwen_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "qwen_tts_tpu")
             or m.startswith(("jax.", "jaxlib.", "qwen_tts_tpu.")))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    expected = len(list(pkgutil.walk_packages(qwen_tts_tpu_torch.__path__,
                                               "qwen_tts_tpu_torch.")))
    assert n_modules == expected >= 20


def test_entry_points_need_a_device_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from qwen_tts_tpu_torch.convert import convert_params
    from qwen_tts_tpu_torch.io.loader import load_checkpoint
    from qwen_tts_tpu_torch.pipeline import Qwen3TTSModel
    from qwen_tts_tpu_torch.utils import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen3TTSModel.from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_params({}, {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_public_surface_is_the_jax_packages():
    """``__all__`` names what the JAX package's does, and each name resolves
    to the port's own object, from the module that defines it."""
    import qwen_tts_tpu

    assert qwen_tts_tpu_torch.__all__ == qwen_tts_tpu.__all__
    assert qwen_tts_tpu_torch.__version__ == qwen_tts_tpu.__version__
    for name in qwen_tts_tpu_torch.__all__:
        obj = getattr(qwen_tts_tpu_torch, name)
        assert obj.__module__.startswith("qwen_tts_tpu_torch."), (name, obj.__module__)
        assert obj is not getattr(qwen_tts_tpu, name)
    with pytest.raises(AttributeError):
        qwen_tts_tpu_torch.NoSuchName  # noqa: B018


_LIGHT = r"""
import sys
import qwen_tts_tpu_torch
loaded = sorted(m for m in sys.modules if m.startswith(("qwen_tts_tpu_torch.", "jax")))
print(loaded)
assert not loaded, loaded
from qwen_tts_tpu_torch import Qwen3TTSModel, ServingEngine
assert "jax" not in sys.modules and "qwen_tts_tpu" not in sys.modules
print(Qwen3TTSModel.__module__, ServingEngine.__module__)
"""


def test_importing_the_package_alone_stays_light():
    """``import qwen_tts_tpu_torch`` loads none of its modules (so neither
    ``pipeline`` nor jax); a public name then loads its own module, still
    without jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _LIGHT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "qwen_tts_tpu_torch.pipeline qwen_tts_tpu_torch.serving" in out.stdout
