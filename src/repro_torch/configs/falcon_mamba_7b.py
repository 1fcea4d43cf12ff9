"""falcon-mamba-7b — mamba-1, attention-free [arXiv:2410.05355; unverified].

Copied from ``src/repro/configs/falcon_mamba_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,  # attention-free, MLP-free mamba blocks
    vocab=65024,
    ssm_state=16,
    d_inner=8192,
    source="[arXiv:2410.05355; unverified]",
)
