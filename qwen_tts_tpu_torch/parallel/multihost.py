"""Multi-process bring-up (the counterpart of
``qwen_tts_tpu/parallel/multihost.py``).

JAX brings up its distributed runtime with ``jax.distributed.initialize``;
the port's counterpart is ``torch.distributed.init_process_group``, after
which the (dp, tp) mesh of ``parallel/mesh.py`` spans every process.

The backend is a rule, not a fallback taken on a failure: NCCL when every
rank has a card of its own (a CUDA device and at least as many local cards
as local ranks), gloo on the CPU or when ranks share a card (NCCL refuses
two ranks on one card).

The rendezvous comes from the arguments or from a launcher's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, as
``torchrun`` sets them); with neither, the single-process case, nothing is
initialized.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A collective or rendezvous that waits longer than this raises.
TIMEOUT = datetime.timedelta(seconds=300)


def choose_backend(world_size: int, local_world_size: Optional[int] = None,
                   device_type: str = "cuda") -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local = world_size if local_world_size is None else local_world_size
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device_type: str = "cuda") -> bool:
    """Initialize ``torch.distributed`` when this is (or may be) a
    multi-process run; a no-op for plain single-process use.

    Returns True when a process group is active after the call. Explicit
    arguments win over the environment: ``coordinator_address`` is an
    ``init_method`` URL (``tcp://host:port`` or ``file://path``) or a bare
    ``host:port``. With no argument and no launcher environment nothing is
    initialized and False is returned. A second call returns True and does
    nothing. ``device_type="cpu"`` keeps the rule on the CPU (gloo); on the
    card each rank takes ``cuda:(rank % cards)``."""
    if dist.is_initialized():
        return True
    env = os.environ
    configured = coordinator_address is not None or "MASTER_ADDR" in env
    if not configured:
        return False
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    local = env.get("LOCAL_WORLD_SIZE")
    backend = choose_backend(world, int(local) if local else None, device_type)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kwargs)
    return True


def writes_files() -> bool:
    """Whether this process writes the run's files (checkpoints, exports):
    global rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> dict:
    """Process topology (logs, a server's health report), the JAX keys with
    their torch meanings: ``process_index`` the global rank,
    ``process_count`` the world size, ``local_devices`` the cards this
    process sees (1 for a CPU process), ``global_devices`` the ranks of the
    world (each rank one device of the mesh; ranks that share a card count
    once each)."""
    initialized = dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_devices": local,
        "global_devices": dist.get_world_size() if initialized else local,
    }
