"""PyTorch/CUDA port of qwen_tts_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout. It imports torch and never jax or
anything of ``qwen_tts_tpu``. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Public surface (the JAX package's names):

    from qwen_tts_tpu_torch import Qwen3TTSModel, Qwen3TTSTokenizer

    model = Qwen3TTSModel.from_pretrained(ckpt_dir)
    wavs, sr = model.generate_custom_voice("Hello!", speaker="aiden")

Each name loads its module at first use, so importing the package alone
imports no model code.
"""

import importlib as _importlib

__version__ = "0.1.0"

__all__ = [
    "Qwen3TTSModel",
    "Qwen3TTSTokenizer",
    "GenerationParams",
    "ServingEngine",
    "ContinuousBatchingEngine",
    "save_voice_clone_prompt",
    "load_voice_clone_prompt",
]

# The module of each public name, under this package.
_HOMES = {
    "Qwen3TTSModel": "pipeline",
    "Qwen3TTSTokenizer": "tokenizer",
    "GenerationParams": "generate",
    "ServingEngine": "serving",
    "ContinuousBatchingEngine": "continuous",
    "save_voice_clone_prompt": "voice_prompt",
    "load_voice_clone_prompt": "voice_prompt",
}


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(f"module 'qwen_tts_tpu_torch' has no attribute {name!r}")
    return getattr(_importlib.import_module(f"{__name__}.{_HOMES[name]}"), name)
