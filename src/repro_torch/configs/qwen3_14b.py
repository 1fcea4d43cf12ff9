"""qwen3-14b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B; hf].

Copied from ``src/repro/configs/qwen3_14b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
