"""Architecture registry of the port: ``get_config(arch_id)``.

Counterpart of ``src/repro/configs/__init__.py``; only ``dlrm-recmg`` is
ported so far (the LM configs come with the LM slice).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm_recmg import CONFIG as _DLRM_RECMG

_ARCHS = {"dlrm-recmg": _DLRM_RECMG}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch]

