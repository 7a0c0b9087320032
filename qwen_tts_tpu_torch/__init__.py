"""PyTorch/CUDA port of qwen_tts_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout. It imports torch and never jax or
anything of ``qwen_tts_tpu``. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
