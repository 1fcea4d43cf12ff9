"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676; hf].

Hybrid block: attention (sliding-window, GQA) and a mamba-1 SSM head run in
parallel on the same input and their outputs are mean-combined, per the
paper's parallel-heads design.  Sliding-window attention keeps the decode
state bounded.

Copied from ``src/repro/configs/hymba_1_5b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    attn_type="sliding",
    window=1024,
    source="[arXiv:2411.13676; hf]",
)
