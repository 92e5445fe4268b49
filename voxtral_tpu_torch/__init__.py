"""voxtral_tpu_torch: the PyTorch/CUDA port of voxtral_tpu, the streaming
speech-to-text engine for Voxtral-Mini-4B-Realtime.

The module tree mirrors `voxtral_tpu/`; the JAX package is the reference the
port is tested against.  This package imports torch and never jax."""

from .config import VoxtralConfig, full_config, tiny_config  # noqa: F401

__version__ = "0.1.0"
