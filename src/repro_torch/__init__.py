"""hipBone in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of the JAX package ``repro`` (which stays the reference). Module
names mirror the reference one to one; the code inside is PyTorch idiom:
plain functions on tensors, an explicit ``device`` argument, and a frozen
``PoissonProblem`` holding tensors on one device.

Device policy (:mod:`repro_torch.device`): entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  Without a GPU and without that
explicit request they raise.  On the CPU every kernel wrapper runs its
plain PyTorch version; a CUDA tensor always takes the kernel or raises.

This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``repro``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
