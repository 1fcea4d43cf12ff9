"""internvl2-26b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

Assigned as [vlm]: the transformer BACKBONE only; the vision frontend is a
STUB — precomputed patch embeddings (``ModelBundle.batch_struct``'s
``frontend``) are spliced over the first ``n_frontend_tokens`` positions
of the sequence.

Copied from ``src/repro/configs/internvl2_26b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="vision",
    n_frontend_tokens=256,
    source="[arXiv:2404.16821; hf]",
)
