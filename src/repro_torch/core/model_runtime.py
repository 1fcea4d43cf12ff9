"""Serving-runtime glue for the RecMG model outputs.

Ported from ``src/repro/core/model_runtime.py``: only ``OutputsRef``
(lines 328-336) so far.  The learned models, their controller and the
Voyager baseline come with the learned-models slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.recmg import RecMGOutputs


@dataclass
class OutputsRef:
    """Mutable holder for the live :class:`RecMGOutputs` — the serving
    loops read through it so an online refresh swaps the outputs without
    re-wiring the loop (the chunk grid is identical, so the loop's chunk
    pointer stays valid)."""

    outputs: Optional[RecMGOutputs] = field(default=None)
