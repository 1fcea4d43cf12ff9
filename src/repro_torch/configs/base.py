"""Model configuration for the port: ``ModelConfig`` and ``reduced()``,
the LM shape cells and the training knobs of ``RunConfig``.

Copied from ``src/repro/configs/base.py``: lines 16-156 (the dataclass and
its CPU-scale ``reduced()``), 164-178 (``ShapeConfig``, ``LM_SHAPES``) and,
trimmed to the fields that training reads, 208-230 (``RunConfig``): the
sharding variant (:mod:`repro_torch.sharding.partition`), DLRM's
``emb_rows``, the MoE's data-local dispatch and gradient compression
among them.  The knobs left
out are XLA's (``constrain_grads``, ``shard_kv_seq``, the Pallas switch,
attention block sizes): the port's CUDA kernels tile by their own sizes.
JAX's ``opt_dtype`` feeds only its dry run (``launch/dryrun.py``, XLA
tooling); the moments' dtype is ``OptConfig.moment_dtype``
(``repro_torch.optim.adamw``), as in JAX's optimizer.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from repro_torch.sharding.partition import EMB_ROWS, VARIANTS

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | dlrm

    # Transformer backbone.
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5

    # Attention variant.
    attn_type: str = "full"  # full | sliding
    window: int = 4096  # sliding-window size when attn_type == "sliding"

    # MoE.
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25

    # SSM (mamba-1).
    ssm_state: int = 0
    d_inner: int = 0  # 0 -> 2 * d_model
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    conv_width: int = 4
    ssm_chunk: int = 256  # chunked selective-scan block length

    # Encoder-decoder (whisper-style).
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500  # stub frame count fed to the encoder

    # Modality frontend stub: number of precomputed patch/frame embeddings
    # spliced into the decoder input sequence ("vlm") or fed to the encoder
    # ("audio").  0 -> no frontend.
    frontend: str = ""  # "" | vision | audio
    n_frontend_tokens: int = 0

    # DLRM (paper's own architecture).
    n_tables: int = 0
    rows_per_table: int = 0
    emb_dim: int = 0
    multi_hot: int = 0  # pooling factor per table
    dense_features: int = 0
    bottom_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()

    # Dtypes.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    source: str = ""  # provenance note: [source; verified-tier]

    # ---------------- derived helpers ----------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or max(1, (self.d_model + 15) // 16)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with a bounded-size per-step state at 500k?"""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2) or 0,
            d_model=min(self.d_model, 64) if self.d_model else 0,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab=min(self.vocab, 512) if self.vocab else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.n_heads:
            # Preserve GQA structure with small heads.
            kw["n_heads"] = 4
            kw["n_kv_heads"] = 2 if self.kv_heads < self.n_heads else 4
            kw["head_dim"] = 16
        if self.n_experts:
            kw["n_experts"] = 4
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_d_ff"] = 64
            kw["capacity_factor"] = 8.0  # droppless at smoke scale
        if self.ssm_state:
            kw["ssm_state"] = 8
            kw["d_inner"] = 128
            kw["dt_rank"] = 4
            kw["ssm_chunk"] = 16
        if self.enc_dec:
            kw["n_enc_layers"] = 2
            kw["enc_len"] = 16
        if self.frontend:
            kw["n_frontend_tokens"] = 8
        if self.family == "dlrm":
            kw.update(
                n_tables=8,
                rows_per_table=256,
                emb_dim=16,
                multi_hot=4,
                dense_features=8,
                bottom_mlp=(32, 16),
                top_mlp=(32, 16, 1),
            )
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


# ---------------------------------------------------------------------------
# Runtime knobs of training
# ---------------------------------------------------------------------------

REMAT = ("full", "none")
GRAD_COMPRESSION = ("", "int8_ef")


@dataclass(frozen=True)
class RunConfig:
    remat: str = "full"  # full | none: recompute each layer in the backward
    logits_chunk: int = 0  # 0 -> whole-sequence logits; else chunked loss
    # DLRM serves and trains through the row-sharded, pool-before-reduce
    # lookup on the active mesh (repro_torch.distributed.mesh).
    dlrm_sharded_lookup: bool = False
    # The MoE's capacity dispatch per data rank (JAX's
    # _moe_dispatch_ffn_sharded) instead of over the global batch.
    moe_local_dispatch: bool = False
    grad_compression: str = ""  # "" | int8_ef: the data all-reduce in int8
    # How an LM's parameters and AdamW state lie over a mesh's ranks
    # (JAX's partition.py:178-208): "fsdp_tp" (tensor parallel over
    # model, FSDP over data), "tp" (no FSDP), "dp" (replicated) or "fsdp"
    # (every axis FSDP, the batch over every axis).  int8_ef keeps the
    # parameters replicated, as JAX's make_compressed_dp_grads runs under
    # shard_map with P() specs (distributed/compression.py:88).
    sharding: str = "fsdp_tp"
    # How DLRM's table rows lie over a mesh (JAX's base.py:218): "all"
    # over data and model, "model" over model alone (each data rank holds
    # every row of its model part).
    emb_rows: str = "all"

    def __post_init__(self):
        if self.sharding == "fsdp_seq":
            raise NotImplementedError(
                "sharding='fsdp_seq' (sequence-parallel prefill, a sharded "
                "decode cache) is not ported: ROADMAP A11c-6c")
        if self.sharding not in VARIANTS:
            raise ValueError(f"sharding {self.sharding!r}: expected one of "
                             f"{VARIANTS}")
        if self.emb_rows not in EMB_ROWS:
            raise ValueError(f"emb_rows {self.emb_rows!r}: expected one of "
                             f"{EMB_ROWS}")
        if self.remat == "dots":
            raise NotImplementedError(
                "remat='dots' is not ported: it is an XLA checkpoint policy "
                "(dots_with_no_batch_dims_saveable); use 'full' or 'none'")
        if self.remat not in REMAT:
            raise ValueError(f"remat {self.remat!r}: expected one of "
                             f"{REMAT}")
        if self.grad_compression not in GRAD_COMPRESSION:
            raise ValueError(f"grad_compression {self.grad_compression!r}: "
                             f"expected one of {GRAD_COMPRESSION}")


LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
