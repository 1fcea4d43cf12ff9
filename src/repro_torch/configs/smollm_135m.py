"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

Copied from ``src/repro/configs/smollm_135m.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
)
