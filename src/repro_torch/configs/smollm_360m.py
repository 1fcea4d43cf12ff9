"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

Copied from ``src/repro/configs/smollm_360m.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    tie_embeddings=True,
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
)
