"""grok-1-314b — 8 experts top-2 MoE [hf:xai-org/grok-1; unverified].

Copied from ``src/repro/configs/grok1_314b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    source="[hf:xai-org/grok-1; unverified]",
)
