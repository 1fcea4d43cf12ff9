"""Architecture registry of the port: ``get_config(arch_id)``.

Counterpart of ``src/repro/configs/__init__.py``.  Ported: ``dlrm-recmg``,
the four dense LMs, the two MoE LMs and the VLM.  The other LM families of
the JAX registry (SSM, hybrid, encoder-decoder) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from repro_torch.configs.base import (LM_SHAPES, ModelConfig,  # noqa: F401
                                      RunConfig, ShapeConfig)
from repro_torch.configs.dlrm_recmg import CONFIG as _DLRM_RECMG
from repro_torch.configs.granite_moe_1b import CONFIG as _GRANITE_MOE_1B
from repro_torch.configs.grok1_314b import CONFIG as _GROK1_314B
from repro_torch.configs.internvl2_26b import CONFIG as _INTERNVL2_26B
from repro_torch.configs.qwen2_5_3b import CONFIG as _QWEN2_5_3B
from repro_torch.configs.qwen3_14b import CONFIG as _QWEN3_14B
from repro_torch.configs.smollm_135m import CONFIG as _SMOLLM_135M
from repro_torch.configs.smollm_360m import CONFIG as _SMOLLM_360M

_ARCHS = {
    "qwen2.5-3b": _QWEN2_5_3B,
    "qwen3-14b": _QWEN3_14B,
    "smollm-360m": _SMOLLM_360M,
    "smollm-135m": _SMOLLM_135M,
    "internvl2-26b": _INTERNVL2_26B,
    "granite-moe-1b-a400m": _GRANITE_MOE_1B,
    "grok-1-314b": _GROK1_314B,
    "dlrm-recmg": _DLRM_RECMG,
}
# LM archs of the JAX registry whose families are not ported yet.
NOT_PORTED = ("whisper-large-v3", "hymba-1.5b", "falcon-mamba-7b")


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} belongs to an LM family the port does not have yet "
            "(SSM, hybrid, encoder-decoder: ROADMAP A11c)")
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch]
