"""distillbev_tpu_torch — the PyTorch/CUDA port of distillbev_tpu.

A second package beside the JAX reference, for one NVIDIA H100.  It
imports torch, numpy and the standard library only, never JAX or the
JAX package.  Its entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.  Every Pallas kernel of the
JAX package on a ported path becomes a kernel written by hand for
Hopper under ``csrc/``.
"""
__version__ = "0.1.0"

from .registry import Registry, build_from_cfg

__all__ = ["Registry", "build_from_cfg", "__version__"]
