"""The device rule of the port's entry points.

Entry points default to ``device="cuda"``.  When the card is asked for and
CUDA is absent they raise; they never carry on on the CPU.  The CPU runs
only when the caller passes ``device="cpu"`` (the tests do).  ``"meta"``
builds shapes and dtypes without memory (a bundle's ``param_struct``).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev


def generator(dev: torch.device, seed: int) -> torch.Generator:
    """A seeded generator for draws on ``dev`` (the CPU's for ``meta``,
    whose draws make no numbers)."""
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
