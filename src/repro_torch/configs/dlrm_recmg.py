"""dlrm-recmg — the paper's own architecture (RecMG's DLRM).

Sized after the paper's evaluation platform: 856 sparse features (we shard
the 62M unique vectors evenly across tables), emb dim 128, bottom/top MLPs
per the open-source DLRM reference [arXiv:1906.00091].  EMBs are row-sharded
across the whole mesh (the "tiered memory" device buffer is the serving-side
feature; at dry-run scale the tables live sharded in HBM).

Copied from ``src/repro/configs/dlrm_recmg.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dlrm-recmg",
    family="dlrm",
    n_tables=856,
    rows_per_table=72704,  # ~62M unique vectors / 856 tables (512-divisible)
    emb_dim=128,
    multi_hot=20,
    dense_features=13,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    source="[arXiv:1906.00091 + paper §VII; calibrated]",
)
