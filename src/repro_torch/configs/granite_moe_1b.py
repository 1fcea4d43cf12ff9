"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Copied from ``src/repro/configs/granite_moe_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
