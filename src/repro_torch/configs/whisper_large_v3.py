"""whisper-large-v3 — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified].

[audio]: the transformer backbone only; the conv/mel frontend is a STUB —
the batch's ``"frontend"`` holds precomputed frame embeddings (enc_len x
d_model) that feed the encoder directly.

Copied from ``src/repro/configs/whisper_large_v3.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    enc_dec=True,
    enc_len=1500,
    frontend="audio",
    n_frontend_tokens=1500,
    rope_theta=10000.0,
    source="[arXiv:2212.04356; unverified]",
)
