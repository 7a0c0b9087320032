"""The port's multi-process bring-up (``qwen_tts_tpu_torch/parallel/
multihost.py``), the counterpart of ``tests/test_multihost.py``: a no-op
without a rendezvous, a one-process bring-up (in a fresh process: a process
group lives as long as its process), idempotence, ``process_info`` and the
backend rule."""

import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from qwen_tts_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_process_is_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        pytest.skip("a process group is already active in this process")
    assert multihost.init_multihost() is False
    assert not dist.is_initialized()
    assert multihost.process_info()["process_count"] == 1
    assert multihost.writes_files()


def test_backend_rule():
    assert multihost.choose_backend(4, device_type="cpu") == "gloo"
    # No card here: gloo whatever the ranks.
    assert multihost.choose_backend(1) == "gloo"


def test_explicit_single_process_bringup_and_idempotence(tmp_path):
    script = f"""
from qwen_tts_tpu_torch.parallel.multihost import init_multihost, process_info, writes_files
from qwen_tts_tpu_torch.parallel.mesh import make_mesh, mesh_place
import torch, torch.distributed as dist
assert init_multihost("file://{tmp_path}/store", 1, 0, device_type="cpu") is True
assert dist.get_backend() == "gloo"
info = process_info()
assert info == {{"process_index": 0, "process_count": 1, "local_devices": 1,
                 "global_devices": 1}}, info
assert init_multihost() is True  # already initialized
x = torch.arange(8.0)
dist.all_reduce(x)
assert float(x.sum()) == 28.0
place = mesh_place(make_mesh(tp=1))
assert (place.dp_size, place.tp_size, place.tp_rank) == (1, 1, 0)
try:
    make_mesh(tp=2)
except ValueError as e:
    assert "not divisible by tp=2" in str(e)
else:
    raise AssertionError("a mesh of 1 over tp=2")
assert writes_files()
dist.destroy_process_group()
print("MULTIHOST-OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MASTER_ADDR", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTIHOST-OK" in out.stdout
