"""qwen2.5-3b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

Copied from ``src/repro/configs/qwen2_5_3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)
