"""Architecture registry of the port: ``get_config(arch_id)``.

Counterpart of ``src/repro/configs/__init__.py``, every arch of it:
``dlrm-recmg``, the four dense LMs, the two MoE LMs, the VLM, the SSM LM
(``falcon-mamba-7b``), the hybrid LM (``hymba-1.5b``) and the
encoder-decoder LM (``whisper-large-v3``).
"""
from __future__ import annotations

from repro_torch.configs.base import (LM_SHAPES, ModelConfig,  # noqa: F401
                                      RunConfig, ShapeConfig)
from repro_torch.configs.dlrm_recmg import CONFIG as _DLRM_RECMG
from repro_torch.configs.falcon_mamba_7b import CONFIG as _FALCON_MAMBA_7B
from repro_torch.configs.granite_moe_1b import CONFIG as _GRANITE_MOE_1B
from repro_torch.configs.grok1_314b import CONFIG as _GROK1_314B
from repro_torch.configs.hymba_1_5b import CONFIG as _HYMBA_1_5B
from repro_torch.configs.internvl2_26b import CONFIG as _INTERNVL2_26B
from repro_torch.configs.qwen2_5_3b import CONFIG as _QWEN2_5_3B
from repro_torch.configs.qwen3_14b import CONFIG as _QWEN3_14B
from repro_torch.configs.smollm_135m import CONFIG as _SMOLLM_135M
from repro_torch.configs.smollm_360m import CONFIG as _SMOLLM_360M
from repro_torch.configs.whisper_large_v3 import CONFIG as _WHISPER_LARGE_V3

_ARCHS = {
    "qwen2.5-3b": _QWEN2_5_3B,
    "qwen3-14b": _QWEN3_14B,
    "smollm-360m": _SMOLLM_360M,
    "smollm-135m": _SMOLLM_135M,
    "internvl2-26b": _INTERNVL2_26B,
    "granite-moe-1b-a400m": _GRANITE_MOE_1B,
    "grok-1-314b": _GROK1_314B,
    "falcon-mamba-7b": _FALCON_MAMBA_7B,
    "hymba-1.5b": _HYMBA_1_5B,
    "whisper-large-v3": _WHISPER_LARGE_V3,
    "dlrm-recmg": _DLRM_RECMG,
}
# Archs of the JAX registry that the port does not build: none.
NOT_PORTED: tuple = ()


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch]
