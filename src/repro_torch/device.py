"""Device policy: the card unless the caller asks for the CPU.

Every entry point that creates tensors takes a ``device`` argument and
resolves it here.  ``None`` means the card; with no card it raises rather
than quietly running the plain versions on the CPU.  ``"cpu"`` is the
explicit opt-in the tests use.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.

    Raises ``RuntimeError`` when ``device`` is None and no CUDA device is
    visible — pass ``device="cpu"`` to run the plain versions on purpose.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; repro_torch runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())
