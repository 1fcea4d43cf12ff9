"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card, checks that the card serves
the same counters as the CPU, then drives the port's main paths at the full
widths of ``dlrm-recmg`` (emb_dim 128, multi_hot 20, 856 tables, bf16 MLPs)
and of ``smollm-135m`` (LM serving with the vocab on tiered memory):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: nvcc for sm_90a, one process per source, with the build seconds;
3. kernels vs plain on the card at the serve and forward shapes, fp32 and
   bf16, D in {16, 128}: the row gathers bit-exact, the pooled gather
   within fp32 rtol 1e-5; each timed beside its byte bound;
3'. the quantized tier's kernels vs plain, int8 and fp8, D in {16, 20,
   128}, at the full-width serve shape (one batch's admit into and read
   from the 720,100-row quantized buffer, with and without overflow rows,
   and the batch's pooled read, idx (32 * 856, 20)), and the admit at the
   per-table facade's shape (one sub-store's 264 first-batch rows into its
   841-row buffer, beside the timer's floor): codes bit-exact, scales
   within one ulp, the row reads bit-exact, the pooled read within fp32
   rtol/atol 1e-6; each timed beside its byte bound;
4. serve parity: the golden-trace fixture through ``serve_trace`` on the
   CPU and on the card, ``lru`` and ``recmg`` (frequency model), with fp32,
   int8 and fp8 rows and through the per-table facade: counters
   identical, logits within fp32 rtol/atol 1e-4 (the two devices sum in
   different orders);
5. full-width serve: ``rows_per_table`` cut to 4096 (a 72,704-row host
   table is 31.9 GB of fp32, drawn as 64 GB of float64 first), 8 batches
   of 32 queries (547,840 ids each), capacity 0.2 of the unique ids
   (185,651 fp32 rows); fp32 ``lru`` and ``recmg``, then the same bytes
   re-spent as 720,100 quantized rows: int8 ``lru`` and ``recmg``, fp8
   ``lru``, and int8 ``lru`` through the per-table facade (856 stores);
6. full-width ``dlrm_forward`` with the 856 full-size tables (72,704 rows,
   15.9 GB of bf16) in device memory and B=256 (cut from the 6,144 of
   ``infer_6k``: the (B, 857, 857) fp32 interaction alone is 18 GB there),
   against the plain lookup on the card; then the same forward with the
   tables quantized to int8 (8 GB), which pools through
   ``gather_pool_dequant``;
7. the learned models' kernels vs plain on the card: ``lstm_cell`` at the
   inference (B=4096) and training (B=256) shapes of every LSTM layer of
   the path (K = 57, 67, 80, 88, 120 at H = 32 or 40), within fp32 abs
   1e-5 on h', c' and the gates; ``chamfer`` at the training shape (B=256, P=5, W=15, F=25)
   and at B=65,536, the loss within rtol 1e-5 and the argmins equal; each
   timed beside its bound, the timer's floor and, for ``lstm_cell``,
   ``torch.lstm_cell``;
   then the gradients through both autograd Functions against autograd
   through the plain versions (max abs error within 1e-6 + 1e-4 times the
   gradient's largest entry); each ``lstm_cell`` record carries its
   achieved TFLOP/s, its share of the bound, whether it beat
   ``torch.lstm_cell``, the kernel's design and the timer's floor (what it
   reads for an empty kernel);
8. learned parity on the golden fixture: the caching, prefetch and Voyager
   models trained on the card (1 epoch), their outputs computed on the card
   and, from the same parameters, on the CPU: decisions equal except where
   a logit or a nearest-candidate margin is under 1e-4 (flips counted);
   the card's outputs served on the CPU and on the card with identical
   counters and logits within rtol/atol 1e-4;
9. the CLI's default path at full width (``--model learned``, the widths
   of ``src/repro/launch/serve.py:569-572``): both models trained on the
   card on the first 2 of the 8 serve batches (1 epoch), their outputs over
   the whole trace, served fp32 (185,651 rows) and int8 (720,100 rows);
   the Voyager arm trained on the first batch and served fp32 on an LRU
   store;
9'. runtime parity at the serve width: the pipelined runtime
   (``async_prefetch``) through the inline scheduler at depths 1 and 2,
   fp32 ``recmg`` (frequency) and int8 ``lru``: counters equal those of
   phase ``serve``'s synchronous runs, the stall equals the demand fetch at
   depth 1 and is strictly less at depth 2; then int8 ``recmg`` through
   the thread scheduler: the accounting identities hold and the engine's
   worker thread launched ``quantize_scatter``;
9''. runtime serve at the serve width: ``overload=2.0`` on the int8 store
   (stale degraded rows read on the card by ``gather_rows_dequant_expand``
   inside ``lookup_resident_device``), ``adapt`` with the frequency model
   and with phase 9's fp32 learned model (its fine-tunes launch
   ``lstm_cell``) on 3 batches of the diurnal regime (a hot-set switch a
   batch; drift windows of one batch, so 2 refreshes), and the CLI's
   ``main`` with ``--workload zipf_hot --async-prefetch`` (its reduced
   config);
10. ``flash_attention`` vs plain on the card: at the LM serve prefill shape
    q (8, 2048, 9, 64), k/v (8, 2048, 3, 64) bf16, at qwen2.5-3b's head
    layout (1, 8192, 16/2, 128) bf16, at fp32 (2, 1024, 8/2, 64) and at a
    ragged S=1,000 in both dtypes: fp32 within rtol/atol 1e-5, bf16 within
    1e-2; each timed beside its bound and beside
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``, with
    its achieved TFLOP/s, share of the bound, design (bf16: tensor cores;
    fp32: FMAs) and, at bf16, its largest error in bf16 ulps;
11. LM parity: full-width smollm-135m (30 layers, d_model 576, 9/3 heads,
    vocab 49,152) from the same seeded parameters on the CPU and on the
    card, a B=2, S=256 prefill and 8 teacher-forced decode steps: logits
    within rtol/atol 1e-4 for an fp32 copy of the config and 5e-2 at bf16;
12. LM serve: ``serve_lm_tiered`` at full width, bf16, B=8 streams, a
    2,048-token prompt (cut from ``prefill_32k``'s B=32, S=32,768) and 64
    greedy steps with the vocab on the tiered store (capacity 0.1 = 4,915
    rows, ``lru``); its first step's logits must equal those of the token
    path (``decode_step``) bit for bit; then one prefill and 8 tiered
    decode steps under ``torch.profiler`` (device busy time and idle
    share, the largest kernels).

Each phase prints one JSON line; any failure exits nonzero.  The line
before the last lists every kernel of the main path with its launches,
error, times and bound, and for the four kernels in their second design
that design (``quantize_scatter`` also with its launches from the single
quantized stores and from the per-table facade of phase ``serve``); the
kernels that the runtime phases drive add those phases' launches and show
them as ``launches_runtime``; the last line is the result.  Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.model_runtime import (  # noqa: E402
    LearnedRecMGModel, train_voyager_arm, voyager_arm_outputs)
from repro_torch.core.recmg import RecMGOutputs, frequency_outputs  # noqa: E402
from repro_torch.core.serving import MultiTableTieredStore  # noqa: E402
from repro_torch.core.tiered import (TieredEmbeddingStore,  # noqa: E402
                                     fast_row_bytes)
from repro_torch.core.trace import TraceGenConfig, generate_trace  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import chamfer_kernel as ck  # noqa: E402
from repro_torch.kernels import embedding_gather as eg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lstm_cell as lc  # noqa: E402
from repro_torch.launch.serve import (_dense_forward,  # noqa: E402
                                      cli_learned_config, serve_trace)
from repro_torch.launch.serve import main as cli_main  # noqa: E402
from repro_torch.launch.serve_lm import serve_lm_tiered  # noqa: E402
from repro_torch.models.dlrm import (dlrm_forward, init_dlrm,  # noqa: E402
                                     quantize_tables)
from repro_torch.models.transformer import (decode_step,  # noqa: E402
                                            init_lm, prefill)
from repro_torch.runtime import DriftConfig  # noqa: E402
from repro_torch.workloads import make_trace, scenario  # noqa: E402

# H100 SXM peaks (NVIDIA's data sheet): device-memory rate, fp32 rate
# outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
CU_SOURCE = "src/repro_torch/kernels/csrc/embedding_gather.cu"
CU_QUANT_SOURCE = "src/repro_torch/kernels/csrc/embedding_quant.cu"
TPU_GATHER_ROWS = "src/repro/kernels/embedding_gather.py:87"
TPU_GATHER_POOL = "src/repro/kernels/embedding_gather.py:113"
TPU_GATHER_ROWS_DEQUANT = "src/repro/kernels/embedding_gather.py:153"
TPU_GATHER_POOL_DEQUANT = "src/repro/kernels/embedding_gather.py:192"
TPU_QUANTIZE_ROWS = "src/repro/kernels/embedding_gather.py:229"
CU_LSTM_SOURCE = "src/repro_torch/kernels/csrc/lstm_cell.cu"
CU_CHAMFER_SOURCE = "src/repro_torch/kernels/csrc/chamfer.cu"
TPU_LSTM_CELL = "src/repro/kernels/lstm_cell.py:54"
TPU_CHAMFER = "src/repro/kernels/chamfer_kernel.py:42"
CU_FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
TPU_FLASH_ATTENTION = "src/repro/kernels/flash_attention.py:80"
# flash_attention shapes (name, B, S, H, K, hd, dtype); the first is the
# LM serve prefill's, which the kernels line reports.
FLASH_SHAPES = (("serve_prefill", 8, 2048, 9, 3, 64, "bf16"),
                ("qwen2.5-3b_heads", 1, 8192, 16, 2, 128, "bf16"),
                ("fp32", 2, 1024, 8, 2, 64, "fp32"),
                ("ragged", 4, 1000, 9, 3, 64, "fp32"),
                ("ragged", 4, 1000, 9, 3, 64, "bf16"))
# The designs of the two kernels redesigned after their first port, as
# their records name them (flash_attention by dtype: fp32 keeps the first
# port's kernel).
FLASH_DESIGN = {
    "bf16": "mma.sync m16n8k16 bf16 -> fp32 on the tensor cores, both "
            "products; 128-query blocks of 8 warps, 64-key tiles "
            "double-buffered by cp.async, ldmatrix (.trans for v), p kept "
            "in registers as bf16",
    "fp32": "fp32 FMAs from shared memory, 64-query x 32-key tiles, p "
            "through shared memory (the first port's kernel)"}
LSTM_DESIGN = ("fp32 FMAs; blocks tile (16-64 rows) x (8 units, 4 gates "
               "each); rows and the block's W slice staged by 16-byte "
               "cp.async; a thread holds 4 rows x 4 gates, 3.2 FMAs a "
               "shared load")
QUANT_DESIGN = ("a lane group per row (a warp at D=128) taking 2 rows at "
                "once (1 when the admit would give the card fewer than 4 "
                "blocks an SM), their streaming loads and slots issued "
                "before the absmax shuffles; rows kept in registers to the "
                "codes (D <= 512); IEEE divisions; one short block per 16 "
                "rows, no grid cap")
CHAMFER_DESIGN = ("a row is a group of 16 lanes (2 a warp, __syncwarp only); "
                  "each lane one w point against all P points of po in one "
                  "pass; rows staged by 16-byte cp.async with one wait; "
                  "minima on 64-bit (value, index) keys, backward in "
                  "registers, forward by shuffle trees; 1 row a block at "
                  "B=256, 8 at B=65,536")
# Kernel -> its design, for the kernels redesigned after their first port.
REDESIGNED = {"flash_attention": FLASH_DESIGN["bf16"],
              "lstm_cell": LSTM_DESIGN,
              "quantize_scatter": QUANT_DESIGN,
              "chamfer": CHAMFER_DESIGN}
# Why no single PyTorch call stands beside a quantized kernel.
NO_LIBRARY = {
    "quantize_scatter": "no PyTorch call quantizes rows per row and "
                        "scatters codes and scales",
    "gather_rows_dequant_expand": "no PyTorch call gathers int8/fp8 rows "
                                  "with per-row scales",
    "gather_rows_dequant": "no PyTorch call gathers int8/fp8 rows with "
                           "per-row scales",
    "gather_pool_dequant": "embedding_bag takes no int8/fp8 table with "
                           "per-row scales",
    "chamfer": "no PyTorch call computes the bidirectional Chamfer",
}
# Every LSTM layer's (input width, hidden) on the learned path: hidden 40
# for the caching model and the prefetch model (caching encoder and
# prefetch enc1 27 -> K=67, both decoders of stack 1 80 -> K=120, prefetch
# enc2 40 -> K=80, prefetch dec2 48 -> K=88) and the Voyager arm's encoder
# (25 -> K=57 at hidden 32).
LSTM_LAYERS = {"encoder": (27, 40), "decoder": (80, 40),
               "prefetch_enc2": (40, 40), "prefetch_dec2": (48, 40),
               "voyager_encoder": (25, 32)}
CHAMFER_SHAPE = (5, 15, 25)  # P = out_len, W = window, F = rep_dim
SERVE_KEYS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
              "on_demand_rows", "evictions", "on_demand_stall_ms",
              "modeled_fetch_ms_per_batch")
SERVE_REPORT = ("batches", "lookups", "hits", "misses", "hit_rate",
                "on_demand_rows", "evictions", "prefetch_hits",
                "p50_batch_ms", "p99_batch_ms", "mean_batch_ms", "gather_s",
                "fetch_s", "model_s", "compute_ms")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, timed with CUDA
    events, with the 50 MB L2 cache flushed before each one (the serving
    path finds its tables cold).  A spin kernel after the flush keeps the
    device busy while the host enqueues ``fn``, so the host's launch
    overhead is not counted as device time."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock

    def __init__(self, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self._floor_ms = None

    def floor_ms(self) -> float:
        """What the timer reads for a kernel that does nothing: the floor
        under every time of a kernel this small (read once)."""
        if self._floor_ms is None:
            self._floor_ms = self(lambda: torch.cuda._sleep(1))
        return self._floor_ms

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def achieved(rec, n_ops):
    """Adds the achieved TFLOP/s and the share of the bound a timed record
    reaches (``bound_ms / ms``)."""
    rec["tflops"] = n_ops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def quantize_bound(m, d):
    """Rows read once, slots read, codes and scales written."""
    return bound_ms(m * d * 4 + m * 4 + m * d + m * 4, 3 * m * d)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of max(|want|, 1): 2^(e - 8)
    for a magnitude in [2^(e-1), 2^e), and 2^-7 below 1.  An output near 0
    sums terms of magnitude ~1 and rounds them, so its own ulp would
    measure nothing; the floor counts it at the ulp of 1."""
    mag = want.float().abs().clamp_min(1.0)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return float(((got.float() - want.float()).abs() / ulp).max())


def n_distinct(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


def phase_build():
    res = _build.build_all()
    ptxas = [ln.strip() for rep in res["ptxas"].values()
             for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(res["seconds"], 3),
          "built": res["built"], "ptxas": ptxas})
    eg._lib()
    eg._qlib()
    lc._lib()
    ck._lib()
    fa._lib()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the main path's shapes.
# ---------------------------------------------------------------------------

def serve_gather_inputs(uniq_n, inv, capacity, d, dtype, with_ov, seed=0):
    """Inputs of the store's read at the full-width serve shape: the
    buffer (capacity, d), the batch's unique slots and inverse, and, with
    ``with_ov``, the share of unique rows the buffer cannot hold as
    overflow rows staged from the host."""
    rng = np.random.default_rng(seed)
    table = torch.randn((capacity, d), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda").to(dtype)
    slots = torch.from_numpy(rng.integers(0, capacity, uniq_n)
                             .astype(np.int32)).cuda()
    inv_t = torch.from_numpy(inv.astype(np.int32)).cuda()
    ov = hr = None
    if with_ov:
        ov = torch.from_numpy(
            rng.random(uniq_n) < max(0.0, 1.0 - capacity / uniq_n)).cuda()
        hr = torch.from_numpy(rng.normal(size=(uniq_n, d))
                              .astype(np.float32)).cuda().to(dtype)
    return table, slots, inv_t, ov, hr


def expand_bound(table, slots, inv, ov, quantized=False):
    """Bound of the store's fused read: each distinct buffer row read once
    (``D + 4`` bytes with its scale when quantized), each overflow row
    read once, each output row written once, the index vectors read once;
    one multiply per dequantized element."""
    d = table.shape[1]
    rb_out = d * (4 if quantized else table.element_size())
    rb_in = d * table.element_size() + (4 if quantized else 0)
    used = torch.unique(inv).long()
    if ov is None:
        rows_read, ov_read, extra = n_distinct(slots[used]), 0, 0
    else:
        keep = ~ov[used]
        rows_read = n_distinct(slots[used[keep]])
        ov_read = int((~keep).sum())
        extra = ov.numel()
    n_bytes = (rows_read * rb_in + ov_read * rb_out + inv.numel() * rb_out
               + inv.numel() * 4 + slots.numel() * 4 + extra)
    return bound_ms(n_bytes, inv.numel() * d if quantized else 0)


def pool_bound(table, idx, quantized=False):
    """Bound of a pooled read: distinct rows read once (with their scale
    when quantized), ids read once, the fp32 sums written once; one add
    per gathered element, and one multiply more when dequantizing."""
    b, p = idx.shape
    d = table.shape[1]
    rb_in = d * table.element_size() + (4 if quantized else 0)
    n_bytes = n_distinct(idx) * rb_in + idx.numel() * 4 + b * d * 4
    return bound_ms(n_bytes, (2 if quantized else 1) * b * p * d)


def phase_kernels(timer, first_batch, capacity, fwd_table_rows, fwd_b, cfg):
    """Every kernel at the serve and forward shapes, fp32 and bf16,
    D in {16, 128}.  Returns the entry of the main path's configuration
    of each kernel (serve: fp32 D=128; forward: bf16 D=128)."""
    uniq, inv = np.unique(first_batch, return_inverse=True)
    u = uniq.size
    overflow = u > capacity
    rng = np.random.default_rng(1)
    main = {}
    for dt_name, dt in DTYPES.items():
        for d in (16, 128):
            # gather_rows (the TPU kernel's contract) and the store's
            # fused gather_rows_expand, with and without overflow rows.
            for with_ov in (False, True):
                table, slots, inv_t, ov, hr = serve_gather_inputs(
                    u, inv, capacity, d, dt, with_ov)
                got = eg.gather_rows_expand(table, slots, inv_t, ov, hr)
                want = ref.gather_rows_expand_ref(table, slots, inv_t, ov, hr)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"gather_rows_expand {dt_name} D={d} ov={with_ov} "
                        "is not bit-exact")
                rec = {"phase": "kernel", "name": "gather_rows_expand",
                       "dtype": dt_name, "D": d, "M": int(inv.size),
                       "U": int(u), "N": capacity, "overflow": with_ov,
                       "max_abs_err": 0.0,
                       "ms": timer(lambda: eg.gather_rows_expand(
                           table, slots, inv_t, ov, hr)),
                       "plain_ms": timer(lambda: ref.gather_rows_expand_ref(
                           table, slots, inv_t, ov, hr)),
                       "library_ms": None}
                rec["bound_ms"], rec["bound_by"] = expand_bound(
                    table, slots, inv_t, ov)
                emit(rec)
                if dt_name == "fp32" and d == 128 and with_ov == overflow:
                    main["gather_rows_expand"] = rec
            idx = torch.from_numpy(rng.integers(0, capacity, inv.size)
                                   .astype(np.int32)).cuda()
            got = eg.gather_rows(table, idx)
            require(torch.equal(got, ref.gather_rows_ref(table, idx)),
                    f"gather_rows {dt_name} D={d} is not bit-exact")
            rec = {"phase": "kernel", "name": "gather_rows", "dtype": dt_name,
                   "D": d, "M": int(idx.numel()), "N": capacity,
                   "max_abs_err": 0.0,
                   "ms": timer(lambda: eg.gather_rows(table, idx)),
                   "plain_ms": timer(lambda: ref.gather_rows_ref(table, idx)),
                   "library_ms": timer(lambda: table.index_select(0, idx))}
            rb = d * table.element_size()
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_distinct(idx) * rb + idx.numel() * (rb + 4))
            emit(rec)
            del table, slots, inv_t, ov, hr, idx
            # gather_pool at the forward shape (B*T rows of P ids).
            table = torch.randn((fwd_table_rows, d), device="cuda").to(dt)
            pidx = torch.from_numpy(rng.integers(
                0, fwd_table_rows, (fwd_b * cfg.n_tables, cfg.multi_hot))
                .astype(np.int32)).cuda()
            got = eg.gather_pool(table, pidx)
            want = ref.gather_pool_ref(table, pidx)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"gather_pool {dt_name} D={d}: max abs err {err}")
            rec = {"phase": "kernel", "name": "gather_pool",
                   "dtype": dt_name, "D": d, "B": int(pidx.shape[0]),
                   "P": cfg.multi_hot, "N": fwd_table_rows,
                   "max_abs_err": err,
                   "ms": timer(lambda: eg.gather_pool(table, pidx)),
                   "plain_ms": timer(lambda: ref.gather_pool_ref(table, pidx)),
                   "library_ms": timer(lambda: torch.nn.functional
                                       .embedding_bag(pidx, table,
                                                      mode="sum"))}
            rec["bound_ms"], rec["bound_by"] = pool_bound(table, pidx)
            emit(rec)
            del table, pidx, got, want
            torch.cuda.empty_cache()
    return main


def quantized_buffer(capacity, d, row_format, seed):
    """A full (capacity, d) quantized buffer of normal rows, quantized by
    the plain version on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return ref.quantize_rows_ref(
        torch.randn((capacity, d), generator=g, device="cuda"), row_format)


def scale_ulps(a, b) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def quantize_rec(timer, fmt, d, rows, slots, buf, sc, **kw):
    """``quantize_scatter`` of ``rows`` into ``buf``/``sc`` at ``slots``
    against the plain version on a copy: codes bit-equal, scales within
    one ulp; then both timed.  Returns the record and the kernel's buffer
    and scales."""
    m = rows.shape[0]
    bufs, scs = [buf, buf.clone()], [sc, sc.clone()]
    eg.quantize_scatter(bufs[0], scs[0], slots, rows, fmt)
    ref.quantize_scatter_ref(bufs[1], scs[1], slots, rows, fmt)
    torch.cuda.synchronize()
    what = f"quantize_scatter {fmt} D={d} M={m}"
    require(torch.equal(bufs[0].view(torch.uint8), bufs[1].view(torch.uint8)),
            f"{what}: codes differ")
    ulps = scale_ulps(scs[0], scs[1])
    require(ulps <= 1, f"{what}: scales {ulps} ulps apart")
    rec = {"phase": "kernel", "name": "quantize_scatter", "row_format": fmt,
           "D": d, "N": buf.shape[0], "M": m, **kw,
           "max_abs_err": float((scs[0] - scs[1]).abs().max()),
           "scale_ulps": ulps, "codes_equal": True,
           "ms": timer(lambda: eg.quantize_scatter(bufs[0], scs[0], slots,
                                                   rows, fmt)),
           "plain_ms": timer(lambda: ref.quantize_scatter_ref(
               bufs[1], scs[1], slots, rows, fmt)),
           "library_ms": None, "library_note": NO_LIBRARY["quantize_scatter"]}
    rec["bound_ms"], rec["bound_by"] = quantize_bound(m, d)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["design"] = QUANT_DESIGN
    return rec, bufs[0], scs[0]


def per_table_admit(trace, first_batch, qcapacity):
    """The admit of one sub-store of the int8 per-table facade (the
    ``int8-multi_table`` serve arm, built the same way): the table whose
    count of the first batch's unique ids is nearest their mean, that
    count and its sub-store's capacity.  The host rows are never read
    here, so one zero row stands in for the table."""
    d = 128
    host = np.broadcast_to(np.zeros((1, d), np.float32),
                           (int(trace.rows_per_table.sum()), d))
    store = MultiTableTieredStore.from_global_table(
        host, trace.rows_per_table, capacity=qcapacity, policy="lru",
        quantize=True, row_format="int8", device="cuda")
    table = np.searchsorted(store.offsets, np.unique(first_batch),
                            side="right") - 1
    counts = np.bincount(table, minlength=len(store.stores))
    t = int(np.argmin(np.abs(counts - counts.mean())))
    caps = [s.capacity for s in store.stores]
    del store
    torch.cuda.empty_cache()
    return {"table": t, "tables": len(caps), "M": int(counts[t]),
            "N": caps[t], "N_range": [min(caps), max(caps)],
            "M_mean": float(counts.mean()),
            "M_median": float(np.median(counts)),
            "M_range": [int(counts.min()), int(counts.max())]}


def phase_quant_kernels(timer, trace, first_batch, qcapacity, cfg):
    """The quantized tier's kernels at the full-width serve shape, int8
    and fp8, D in {16, 20, 128}: batch 0 misses on every unique id, so its
    admit writes U rows into the 720,100-row buffer, and its read expands
    U slots to the batch's M ids.  Then ``quantize_scatter`` at the
    per-table facade's admit shape (D=128: one sub-store's first-batch
    rows into slots 0.. of its buffer, as its first admit writes them),
    beside the timer's floor.  Returns the entry of the main path's
    configuration of each kernel (int8, D=128)."""
    uniq, inv = np.unique(first_batch, return_inverse=True)
    u = uniq.size
    overflow = u > qcapacity
    inv_t = torch.from_numpy(inv.astype(np.int32)).cuda()
    rng = np.random.default_rng(3)
    main = {}

    def kernel_rec(name, fmt, d, **kw):
        rec = {"phase": "kernel", "name": name, "row_format": fmt, "D": d,
               "N": qcapacity, **kw}
        if "library_ms" not in rec:
            rec["library_ms"] = None
            rec["library_note"] = NO_LIBRARY[name]
        return rec

    sub = per_table_admit(trace, first_batch, qcapacity)
    for fmt in ("int8", "fp8"):
        g = torch.Generator(device="cuda").manual_seed(7)
        rows = torch.randn((sub["M"], 128), generator=g, device="cuda")
        slots = torch.arange(sub["M"], dtype=torch.int32, device="cuda")
        buf, sc = quantized_buffer(sub["N"], 128, fmt, seed=7)
        rec, _, _ = quantize_rec(timer, fmt, 128, rows, slots, buf, sc,
                                 shape="per_table_admit", **sub)
        rec["timer_floor_ms"] = timer.floor_ms()
        emit(rec)
    for fmt in ("int8", "fp8"):
        for d in (16, 20, 128):
            is_main = fmt == "int8" and d == 128
            # The admit: quantize U fp32 rows into U distinct slots.
            g = torch.Generator(device="cuda").manual_seed(d)
            rows = torch.randn((u, d), generator=g, device="cuda")
            slots = torch.from_numpy(rng.permutation(qcapacity)[:u]
                                     .astype(np.int32)).cuda()
            buf, sc = quantized_buffer(qcapacity, d, fmt, seed=d)
            rec, table, scales = quantize_rec(timer, fmt, d, rows, slots,
                                              buf, sc, shape="full_batch")
            emit(rec)
            if is_main:
                main["quantize_scatter"] = rec
            del rows, buf, sc
            # The read: U slots expanded to the batch's M ids, with and
            # without overflow rows (10% of the unique ids) from the host.
            slots_r = torch.from_numpy(rng.integers(0, qcapacity, u)
                                       .astype(np.int32)).cuda()
            for with_ov in (False, True):
                ov = hr = None
                if with_ov:
                    ov = torch.from_numpy(rng.random(u) < 0.1).cuda()
                    hr = torch.randn((u, d), generator=g, device="cuda")
                got = eg.gather_rows_dequant_expand(table, scales, slots_r,
                                                    inv_t, ov, hr)
                want = ref.gather_rows_dequant_expand_ref(
                    table, scales, slots_r, inv_t, ov, hr)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"gather_rows_dequant_expand {fmt} D={d} "
                        f"ov={with_ov} is not bit-exact")
                rec = kernel_rec(
                    "gather_rows_dequant_expand", fmt, d, M=int(inv.size),
                    U=int(u), overflow=with_ov, max_abs_err=0.0,
                    ms=timer(lambda: eg.gather_rows_dequant_expand(
                        table, scales, slots_r, inv_t, ov, hr)),
                    plain_ms=timer(lambda: ref.gather_rows_dequant_expand_ref(
                        table, scales, slots_r, inv_t, ov, hr)))
                rec["bound_ms"], rec["bound_by"] = expand_bound(
                    table, slots_r, inv_t, ov, quantized=True)
                emit(rec)
                if is_main and with_ov == overflow:
                    main["gather_rows_dequant_expand"] = rec
                del got, want, ov, hr
            # The TPU kernel's own contract: M random slots, no expansion.
            idx = torch.from_numpy(rng.integers(0, qcapacity, inv.size)
                                   .astype(np.int32)).cuda()
            require(torch.equal(eg.gather_rows_dequant(table, scales, idx),
                                ref.gather_rows_dequant_ref(table, scales,
                                                            idx)),
                    f"gather_rows_dequant {fmt} D={d} is not bit-exact")
            rec = kernel_rec(
                "gather_rows_dequant", fmt, d, M=int(idx.numel()),
                max_abs_err=0.0,
                ms=timer(lambda: eg.gather_rows_dequant(table, scales, idx)),
                plain_ms=timer(lambda: ref.gather_rows_dequant_ref(
                    table, scales, idx)))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_distinct(idx) * (d + 4) + idx.numel() * (4 * d + 4),
                idx.numel() * d)
            emit(rec)
            # The batch's pooled read: each query's P ids of each table.
            pidx = slots_r[inv_t.long()].reshape(-1, cfg.multi_hot)
            got = eg.gather_pool_dequant(table, scales, pidx)
            want = ref.gather_pool_dequant_ref(table, scales, pidx)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                    f"gather_pool_dequant {fmt} D={d}: max abs err {err}")
            rec = kernel_rec(
                "gather_pool_dequant", fmt, d, B=int(pidx.shape[0]),
                P=cfg.multi_hot, max_abs_err=err,
                ms=timer(lambda: eg.gather_pool_dequant(table, scales, pidx)),
                plain_ms=timer(lambda: ref.gather_pool_dequant_ref(
                    table, scales, pidx)))
            rec["bound_ms"], rec["bound_by"] = pool_bound(table, pidx,
                                                          quantized=True)
            emit(rec)
            del table, scales, slots_r, idx, pidx, got, want
            torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# Phase 4: the same small serve on the CPU and on the card.
# ---------------------------------------------------------------------------

def to_device(params, dev):
    return {"emb": params["emb"].to(dev),
            **{k: {"w": [w.to(dev) for w in params[k]["w"]],
                   "b": [b.to(dev) for b in params[k]["b"]]}
               for k in ("bottom", "top")}}


def phase_parity():
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    params = init_dlrm(cfg, seed=0, device="cpu")
    for rows, kw in (("fp32", {}),
                     ("int8", dict(quantize=True, row_format="int8")),
                     ("fp8", dict(quantize=True, row_format="fp8")),
                     ("fp32-multi_table", dict(multi_table=True))):
        for policy in ("lru", "recmg"):
            outputs = (frequency_outputs(trace, cap) if policy == "recmg"
                       else None)
            res = {dev: serve_trace(cfg, to_device(params, dev), trace, cap,
                                    policy, outputs, batch_queries=8,
                                    device=dev, collect_logits=True, **kw)
                   for dev in ("cpu", "cuda")}
            cpu, card = res["cpu"], res["cuda"]
            diff = {k: (cpu[k], card[k]) for k in SERVE_KEYS
                    if cpu[k] != card[k]}
            require(not diff, f"serve counters differ CPU vs card ({rows}, "
                              f"{policy}): {diff}")
            err = float(np.abs(cpu["logits"] - card["logits"]).max())
            require(np.allclose(card["logits"], cpu["logits"], rtol=1e-4,
                                atol=1e-4),
                    f"serve logits differ CPU vs card ({rows}, {policy}): "
                    f"{err}")
            emit({"phase": "serve_parity", "rows": rows, "policy": policy,
                  "counters_equal": True,
                  **{k: card[k] for k in SERVE_KEYS},
                  "logits_max_abs_err": err})


# ---------------------------------------------------------------------------
# Phases 5 and 6: the main path at full width.
# ---------------------------------------------------------------------------

def phase_serve(cfg, trace, runs, batch_queries):
    """Each run ``(rows, policy, capacity, serve_trace kwargs)`` serves the
    trace with the counts set to 0 just before and read just after; every
    kernel of the run's path must have launched.  Returns each kernel's
    launches summed over the runs of its path, the results, and
    ``quantize_scatter``'s launches by kind of store: ``full_batch`` (one
    quantized store: a warm-up and one admit of the batch's misses per
    batch) and ``per_table`` (the facade: a warm-up and one admit per
    sub-store and batch)."""
    launches, results = {}, {}
    by_store = {"full_batch": 0, "per_table": 0}
    params = init_dlrm(cfg, seed=0, device="cuda")
    for rows, policy, capacity, kw in runs:
        outputs = (frequency_outputs(trace, capacity)
                   if policy == "recmg" else None)
        path = (("quantize_scatter", "gather_rows_dequant_expand")
                if kw.get("quantize") else ("gather_rows_expand",))
        eg.reset_launches()
        res = serve_trace(cfg, params, trace, capacity, policy, outputs,
                          batch_queries=batch_queries, device="cuda",
                          collect_logits=True, **kw)
        n = {name: getattr(eg, name).launches for name in path}
        for name, k in n.items():
            require(k > 0, f"serve ({rows}, {policy}) launched {name} 0 "
                           "times")
            launches[name] = launches.get(name, 0) + k
        if kw.get("quantize"):
            kind = "per_table" if kw.get("multi_table") else "full_batch"
            by_store[kind] += n["quantize_scatter"]
        require(res["hits"] + res["misses"] == res["lookups"],
                f"serve ({rows}, {policy}): hits + misses != lookups")
        lg = res["logits"]
        require(lg.shape == (res["batches"], batch_queries)
                and np.isfinite(lg).all(),
                f"serve ({rows}, {policy}): logits {lg.shape} not finite")
        results[(rows, policy)] = res
        emit({"phase": "serve", "rows": rows, "policy": policy,
              "batch_queries": batch_queries,
              "ids_per_batch": batch_queries * cfg.n_tables * cfg.multi_hot,
              "capacity": capacity, "launches": n,
              **{k: res[k] for k in SERVE_REPORT}})
    del params
    torch.cuda.empty_cache()
    return launches, results, by_store


def phase_forward(timer, cfg, b):
    params = init_dlrm(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    dense = torch.from_numpy(rng.normal(size=(b, cfg.dense_features))
                             .astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(
        0, cfg.rows_per_table, (b, cfg.n_tables, cfg.multi_hot))
        .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    eg.reset_launches()
    logits = dlrm_forward(params, cfg, dense, idx)
    torch.cuda.synchronize()
    launches = eg.gather_pool.launches
    require(launches > 0, "dlrm_forward launched gather_pool 0 times")
    require(logits.shape == (b,) and bool(torch.isfinite(logits).all()),
            "dlrm_forward logits not finite")
    # The plain path on the card: the same lookup through the plain version.
    t, r, d = params["emb"].shape
    flat_table = params["emb"].reshape(t * r, d)
    off = torch.arange(t, device="cuda", dtype=torch.int32) * r
    flat_idx = (idx + off[None, :, None]).reshape(b * t, -1).contiguous()
    pooled = eg.gather_pool(flat_table, flat_idx)
    pooled_plain = ref.gather_pool_ref(flat_table, flat_idx)
    err = float((pooled - pooled_plain).abs().max())
    require(torch.allclose(pooled, pooled_plain, rtol=1e-5, atol=1e-5),
            f"gather_pool at the forward shape: max abs err {err}")
    plain_logits = _dense_forward(
        params, cfg, dense, pooled_plain.reshape(b, t, d).to(torch.bfloat16)
    ).float()
    lerr = float((logits - plain_logits).abs().max())
    # bf16 tolerance: the fp32 pooled sums round to bf16 at other points.
    require(torch.allclose(logits, plain_logits, rtol=2e-2, atol=2e-2),
            f"dlrm_forward vs plain lookup: max abs err {lerr}")
    rec = {"name": "gather_pool", "dtype": "bf16", "D": d, "B": b * t,
           "P": cfg.multi_hot, "N": t * r, "max_abs_err": err,
           "ms": timer(lambda: eg.gather_pool(flat_table, flat_idx)),
           "plain_ms": timer(lambda: ref.gather_pool_ref(flat_table,
                                                         flat_idx)),
           "library_ms": timer(lambda: torch.nn.functional.embedding_bag(
               flat_idx, flat_table, mode="sum"))}
    rec["bound_ms"], rec["bound_by"] = pool_bound(flat_table, flat_idx)
    fwd_ms = timer(lambda: dlrm_forward(params, cfg, dense, idx))
    emit({"phase": "forward", "B": b, "tables": t, "rows_per_table": r,
          "emb_gb": params["emb"].numel() * params["emb"].element_size()
          / 1e9, "launches": {"gather_pool": launches},
          "logits_vs_plain_max_abs_err": lerr, "forward_ms": fwd_ms,
          "kernel": rec})
    del flat_table, pooled, pooled_plain
    qrec, qlaunches = forward_quantized(timer, cfg, params, dense, idx,
                                        logits)
    return rec, launches, qrec, qlaunches


def forward_quantized(timer, cfg, params, dense, idx, bf16_logits):
    """The same forward with the tables quantized to int8 on the card (one
    ``quantize_scatter`` per table, set-up), which pools through
    ``gather_pool_dequant``, against the plain pooled read."""
    b = dense.shape[0]
    qparams = quantize_tables(params, "int8")
    del params["emb"]
    torch.cuda.synchronize()
    eg.reset_launches()
    logits = dlrm_forward(qparams, cfg, dense, idx)
    torch.cuda.synchronize()
    launches = eg.gather_pool_dequant.launches
    require(launches > 0, "int8 dlrm_forward launched gather_pool_dequant "
                          "0 times")
    require(logits.shape == (b,) and bool(torch.isfinite(logits).all()),
            "int8 dlrm_forward logits not finite")
    t, r, d = qparams["emb"].shape
    codes = qparams["emb"].reshape(t * r, d)
    scales = qparams["emb_scales"].reshape(t * r)
    off = torch.arange(t, device="cuda", dtype=torch.int32) * r
    flat_idx = (idx + off[None, :, None]).reshape(b * t, -1).contiguous()
    pooled = eg.gather_pool_dequant(codes, scales, flat_idx)
    pooled_plain = ref.gather_pool_dequant_ref(codes, scales, flat_idx)
    err = float((pooled - pooled_plain).abs().max())
    require(torch.allclose(pooled, pooled_plain, rtol=1e-6, atol=1e-6),
            f"gather_pool_dequant at the forward shape: max abs err {err}")
    plain_logits = _dense_forward(qparams, cfg, dense,
                                  pooled_plain.reshape(b, t, d)).float()
    lerr = float((logits - plain_logits).abs().max())
    require(torch.allclose(logits, plain_logits, rtol=2e-2, atol=2e-2),
            f"int8 dlrm_forward vs plain lookup: max abs err {lerr}")
    rec = {"name": "gather_pool_dequant", "row_format": "int8", "D": d,
           "B": b * t, "P": cfg.multi_hot, "N": t * r, "max_abs_err": err,
           "ms": timer(lambda: eg.gather_pool_dequant(codes, scales,
                                                      flat_idx)),
           "plain_ms": timer(lambda: ref.gather_pool_dequant_ref(
               codes, scales, flat_idx)),
           "library_ms": None,
           "library_note": NO_LIBRARY["gather_pool_dequant"]}
    rec["bound_ms"], rec["bound_by"] = pool_bound(codes, flat_idx,
                                                  quantized=True)
    fwd_ms = timer(lambda: dlrm_forward(qparams, cfg, dense, idx))
    emit({"phase": "forward_quantized", "row_format": "int8", "B": b,
          "emb_gb": (codes.numel() + 4 * scales.numel()) / 1e9,
          "launches": {"gather_pool_dequant": launches},
          "logits_vs_plain_max_abs_err": lerr,
          "logits_vs_bf16_tables_max_abs_err":
              float((logits - bf16_logits).abs().max()),
          "forward_ms": fwd_ms, "kernel": rec})
    return rec, launches


# ---------------------------------------------------------------------------
# Phases 7-9: the learned models' kernels, parity and full-width path.
# ---------------------------------------------------------------------------

def cuda_normal(shape, rng, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).cuda()


def lstm_inputs(b, in_dim, hid, seed):
    """x, h, c, W, b of one LSTM step, W scaled like ``lstm_init``."""
    rng = np.random.default_rng(seed)
    k = in_dim + hid
    return (cuda_normal((b, in_dim), rng), cuda_normal((b, hid), rng),
            cuda_normal((b, hid), rng), cuda_normal((k, 4 * hid), rng,
                                                    k ** -0.5),
            cuda_normal((4 * hid,), rng, 0.5))


def phase_learned_kernels(timer):
    """``lstm_cell`` and ``chamfer`` against their plain versions at the
    learned path's shapes.  Returns the records the kernels line takes:
    ``lstm_cell`` at the inference shape of the decoder (B=4096, K=120, no
    gates saved) and ``chamfer`` at the training shape (B=256)."""
    main = {}
    floor_ms = timer.floor_ms()
    for b in (4096, 256):
        train = b == 256  # training saves the gates for the backward
        for layer, (in_dim, hid) in LSTM_LAYERS.items():
            k = in_dim + hid
            x, h, c, w, bias = lstm_inputs(b, in_dim, hid, b + k)
            got = lc.lstm_cell(x, h, c, w, bias)
            want = ref.lstm_cell_ref(x, h, c, w, bias)
            w_ih, w_hh = w[:in_dim].t().contiguous(), w[in_dim:].t().contiguous()
            b_hh = torch.zeros_like(bias)
            lib = torch.lstm_cell(x, (h, c), w_ih, w_hh, bias, b_hh)
            torch.cuda.synchronize()
            errs = {n: float((g - r).abs().max())
                    for n, g, r in zip(("h", "c", "gates"), got, want)}
            err = max(errs.values())
            require(err <= 1e-5, f"lstm_cell B={b} K={k}: max abs err "
                                 f"{errs} > 1e-5")
            rec = {"phase": "kernel", "name": "lstm_cell", "layer": layer,
                   "B": b, "K": k, "H": hid, "saves_gates": train,
                   "max_abs_err": err, "max_abs_err_by_output": errs,
                   "library_max_abs_err": max(
                       float((lib[0] - want[0]).abs().max()),
                       float((lib[1] - want[1]).abs().max())),
                   "ms": timer(lambda: lc.lstm_cell(x, h, c, w, bias,
                                                    save_gates=train)),
                   "plain_ms": timer(lambda: ref.lstm_cell_ref(x, h, c, w,
                                                               bias)),
                   "library_ms": timer(lambda: torch.lstm_cell(
                       x, (h, c), w_ih, w_hh, bias, b_hh))}
            n_bytes = 4 * (b * in_dim + 4 * b * hid + k * 4 * hid + 4 * hid
                           + (b * 4 * hid if train else 0))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_bytes, 2 * b * k * 4 * hid)
            achieved(rec, 2 * b * k * 4 * hid)
            rec["beats_library"] = rec["ms"] <= rec["library_ms"]
            rec["timer_floor_ms"] = floor_ms
            rec["design"] = LSTM_DESIGN
            emit(rec)
            if b == 4096 and layer == "decoder":
                main["lstm_cell"] = rec
    n_p, n_w, n_f = CHAMFER_SHAPE
    for b in (256, 65536):
        rng = np.random.default_rng(b)
        po = cuda_normal((b, n_p, n_f), rng)
        w = cuda_normal((b, n_w, n_f), rng)
        loss, af, ab = ck.chamfer(po, w, 0.7)
        rl, raf, rab = ref.chamfer_ref(po, w, 0.7)
        torch.cuda.synchronize()
        rel = float(((loss - rl).abs() / rl.abs()).max())
        args_equal = bool(torch.equal(af, raf) and torch.equal(ab, rab))
        require(rel <= 1e-5, f"chamfer B={b}: max rel err {rel} > 1e-5")
        require(args_equal, f"chamfer B={b}: argmins differ from plain")
        rec = {"phase": "kernel", "name": "chamfer", "B": b, "P": n_p,
               "W": n_w, "F": n_f, "max_abs_err": float((loss - rl).abs()
                                                        .max()),
               "max_rel_err": rel, "argmins_equal": args_equal,
               "ms": timer(lambda: ck.chamfer(po, w, 0.7)),
               "plain_ms": timer(lambda: ref.chamfer_ref(po, w, 0.7)),
               "library_ms": None, "library_note": NO_LIBRARY["chamfer"]}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * b * ((n_p + n_w) * n_f + 1 + n_p + n_w),
            3 * b * n_p * n_w * n_f)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["timer_floor_ms"] = floor_ms
        rec["design"] = CHAMFER_DESIGN
        emit(rec)
        if b == 256:
            main["chamfer"] = rec
    return main


def grads_close(got, want, what, rtol=1e-4, atol=1e-6) -> dict:
    """Max abs difference of two gradients, required to be within ``atol +
    rtol * max|want|``: the tolerance is scaled by the gradient's size, not
    by each entry's, since an entry that sums 256 rows' products can
    cancel to near zero while keeping the rounding of its terms.  Returns
    the error, the scale it was held to, and how many entries the
    elementwise ``atol + rtol * |want|`` would have refused."""
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    require(err <= atol + rtol * scale,
            f"{what}: max abs err {err} > {atol} + {rtol} * {scale}")
    over = int((diff > atol + rtol * want.abs()).sum())
    return {"max_abs_err": err, "scale": scale, "elementwise_over": over,
            "entries": want.numel()}


def phase_learned_grads():
    """Gradients through the two autograd Functions (kernel forward,
    PyTorch backward) against autograd through the plain versions, at the
    training shapes, on the same inputs."""
    rng = np.random.default_rng(5)
    out = {}
    for layer, (in_dim, hid) in LSTM_LAYERS.items():
        ins = [t.requires_grad_() for t in lstm_inputs(256, in_dim, hid, 7)]
        gh = cuda_normal((256, hid), rng)
        gc = cuda_normal((256, hid), rng)
        h2, c2 = ops.lstm_cell(*ins)
        ((h2 * gh).sum() + (c2 * gc).sum()).backward()
        plain = [t.detach().clone().requires_grad_() for t in ins]
        ph, pc, _ = ref.lstm_cell_ref(*plain)
        ((ph * gh).sum() + (pc * gc).sum()).backward()
        for name, t, p in zip(("x", "h", "c", "w", "b"), ins, plain):
            out[f"lstm_cell_{layer}_{name}"] = grads_close(
                t.grad, p.grad, f"lstm_cell {layer} grad {name}")
    n_p, n_w, n_f = CHAMFER_SHAPE
    po = cuda_normal((256, n_p, n_f), rng).requires_grad_()
    w = cuda_normal((256, n_w, n_f), rng)
    g = cuda_normal((256,), rng)
    (ops.chamfer(po, w, 0.7) * g).sum().backward()
    pp = po.detach().clone().requires_grad_()
    (ref.chamfer_ref(pp, w, 0.7)[0] * g).sum().backward()
    out["chamfer_po"] = grads_close(po.grad, pp.grad, "chamfer grad po")
    emit({"phase": "learned_grads", "rtol": 1e-4, "atol": 1e-6,
          "tolerance": "max abs err <= atol + rtol * max |plain grad|",
          "grads": out})


def decision_flips(card, cpu, card_margin, cpu_margin, what):
    """Decisions of the two devices must agree wherever both margins are
    at least 1e-4; returns the number of flips (all of them near a tie)."""
    flips = card != cpu
    near = (np.broadcast_to(card_margin, flips.shape) < 1e-4) | \
        (np.broadcast_to(cpu_margin, flips.shape) < 1e-4)
    require(not (flips & ~near).any(),
            f"{what}: {int((flips & ~near).sum())} decisions differ CPU vs "
            "card with a margin of at least 1e-4")
    return int(flips.sum())


def phase_learned_parity():
    """The learned models trained on the card on the golden fixture; their
    outputs on the card and, from the same parameters, on the CPU; the
    card's outputs served on both devices."""
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    cap = int(0.15 * trace.unique_count())
    lcfg = dataclasses.replace(cli_learned_config(1), train_stride=2)
    card = LearnedRecMGModel.train_from_trace(trace, cap, lcfg,
                                              device="cuda")
    cpu = card.to("cpu")
    data, starts = card.serving_windows(trace)
    got = {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        logits = m.predict_logits(data)
        pts = m.predict_points(data)
        ids, gaps = m.decode_points(pts, return_margins=True)
        got[dev] = (logits, pts, ids, gaps)
    (cl, cp, ci, cg), (pl, pp, pi, pg) = got["cuda"], got["cpu"]
    logit_diff = float(np.abs(cl - pl).max())
    point_diff = float(np.abs(cp - pp).max())
    require(logit_diff <= 1e-5 and point_diff <= 1e-5,
            f"card vs CPU model outputs: logits {logit_diff}, points "
            f"{point_diff} (max abs, allowed 1e-5)")
    bit_flips = decision_flips(cl > 0, pl > 0, np.abs(cl), np.abs(pl),
                               "keep bits")
    id_flips = decision_flips(ci, pi, cg, pg, "prefetch ids")
    vmodel, cand, vlosses = train_voyager_arm(trace, cap, epochs=1,
                                              device="cuda")
    vcard, vgap = voyager_arm_outputs(vmodel, cand, trace,
                                      return_margins=True)
    vcpu, vgap_cpu = voyager_arm_outputs(
        copy.deepcopy(vmodel).to("cpu"), cand, trace, return_margins=True)
    v_flips = decision_flips(vcard.prefetch_ids, vcpu.prefetch_ids,
                             vgap[:, None], vgap_cpu[:, None],
                             "voyager prefetch ids")
    params = init_dlrm(cfg, seed=0, device="cpu")
    served = {}
    for arm, policy, outputs in (
            ("learned", "recmg", RecMGOutputs(starts, cl > 0, ci)),
            ("voyager", "lru", vcard)):
        res = {dev: serve_trace(cfg, to_device(params, dev), trace, cap,
                                policy, outputs, batch_queries=8, device=dev,
                                collect_logits=True)
               for dev in ("cpu", "cuda")}
        diff = {k: (res["cpu"][k], res["cuda"][k]) for k in SERVE_KEYS
                if res["cpu"][k] != res["cuda"][k]}
        require(not diff, f"learned serve counters differ CPU vs card "
                          f"({arm}): {diff}")
        err = float(np.abs(res["cpu"]["logits"] - res["cuda"]["logits"])
                    .max())
        require(np.allclose(res["cuda"]["logits"], res["cpu"]["logits"],
                            rtol=1e-4, atol=1e-4),
                f"learned serve logits differ CPU vs card ({arm}): {err}")
        served[arm] = {"counters_equal": True, "logits_max_abs_err": err,
                       **{k: res["cuda"][k] for k in SERVE_KEYS}}
    emit({"phase": "learned_parity", "capacity": cap, "windows": len(data),
          "caching_losses": [card.caching_losses[0], card.caching_losses[-1]],
          "prefetch_losses": [card.prefetch_losses[0],
                              card.prefetch_losses[-1]],
          "voyager_losses": [vlosses[0], vlosses[-1]],
          "logits_max_abs_diff": logit_diff,
          "points_max_abs_diff": point_diff,
          "min_abs_logit": float(min(np.abs(cl).min(), np.abs(pl).min())),
          "min_decode_margin": float(min(cg.min(), pg.min())),
          "flips": {"keep_bits": bit_flips, "prefetch_ids": id_flips,
                    "voyager_ids": v_flips},
          "serve": served})


def phase_learned_serve(cfg, trace, capacity, qcapacity, per_batch,
                        batch_queries, baseline):
    """The CLI's default path at full width: ``--model learned`` trained on
    the first 2 of the 8 batches (1 epoch) and served fp32 and int8, and the
    Voyager arm trained on the first batch and served fp32 on LRU.  Counts
    are set to 0 just before each arm's training and read just after its
    serve.  Returns each kernel's launches summed over the arms, and the
    fp32 learned model."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    lcfg = cli_learned_config(1)
    launches = {"lstm_cell": 0, "chamfer": 0}
    summary = {}
    int8 = dict(quantize=True, row_format="int8")
    for rows, cap, kw in (("fp32", capacity, {}), ("int8", qcapacity, int8)):
        ops.reset_launches()
        t0 = time.perf_counter()
        model = LearnedRecMGModel.train_from_trace(
            trace, cap, lcfg, profile_upto=2 * per_batch, device="cuda")
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outputs = model.outputs_for(trace)
        outputs_s = time.perf_counter() - t0
        res = serve_trace(cfg, params, trace, cap, "recmg", outputs,
                          batch_queries=batch_queries, device="cuda",
                          collect_logits=True, **kw)
        path = ("lstm_cell", "chamfer") + (
            ("quantize_scatter", "gather_rows_dequant_expand")
            if kw else ("gather_rows_expand",))
        n = {fn.__name__: fn.launches for fn in ops.KERNELS
             if fn.__name__ in path}
        for name in path:
            require(n[name] > 0, f"learned serve ({rows}) launched {name} "
                                 "0 times")
        launches["lstm_cell"] += n["lstm_cell"]
        launches["chamfer"] += n["chamfer"]
        lg = res["logits"]
        require(lg.shape == (res["batches"], batch_queries)
                and np.isfinite(lg).all()
                and res["hits"] + res["misses"] == res["lookups"],
                f"learned serve ({rows}): bad result")
        require(np.isfinite(model.caching_losses).all()
                and np.isfinite(model.prefetch_losses).all(),
                f"learned serve ({rows}): non-finite training loss")
        summary[(rows, "recmg-learned")] = res
        emit({"phase": "learned_serve", "rows": rows, "model": "learned",
              "capacity": cap, "launches": n,
              "cuts": {"profile_upto": 2 * per_batch,
                       "train_batches": "first 2 of 8", "epochs": 1},
              "train_windows_stride": lcfg.train_stride,
              "stage_s": {**{k: round(v, 3) for k, v in
                             model.timings.items()},
                          "train_total_s": round(train_s, 3),
                          "outputs_for_s": round(outputs_s, 3)},
              "chunks": int(len(outputs.chunk_starts)),
              "caching_steps": len(model.caching_losses),
              "prefetch_steps": len(model.prefetch_losses),
              "caching_loss_first_last": [model.caching_losses[0],
                                          model.caching_losses[-1]],
              "prefetch_loss_first_last": [model.prefetch_losses[0],
                                           model.prefetch_losses[-1]],
              "keep_bit_share": float(outputs.caching_bits.mean()),
              **{k: res[k] for k in SERVE_REPORT}})
        if rows == "fp32":
            kept = model  # phase runtime_serve adapts it online
        del model, outputs, res
    ops.reset_launches()
    t0 = time.perf_counter()
    vmodel, cand, vlosses = train_voyager_arm(trace, capacity, epochs=1,
                                              profile_upto=per_batch,
                                              device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outputs = voyager_arm_outputs(vmodel, cand, trace)
    outputs_s = time.perf_counter() - t0
    res = serve_trace(cfg, params, trace, capacity, "lru", outputs,
                      batch_queries=batch_queries, device="cuda",
                      collect_logits=True)
    n = {fn.__name__: fn.launches for fn in ops.KERNELS
         if fn.__name__ in ("lstm_cell", "gather_rows_expand")}
    for name, k in n.items():
        require(k > 0, f"voyager serve launched {name} 0 times")
    require(np.isfinite(res["logits"]).all() and np.isfinite(vlosses).all(),
            "voyager serve: non-finite logits or losses")
    launches["lstm_cell"] += n["lstm_cell"]
    summary[("fp32", "voyager")] = res
    emit({"phase": "learned_serve", "rows": "fp32", "model": "voyager",
          "capacity": capacity, "launches": n,
          "cuts": {"profile_upto": per_batch, "train_batches": "first 1 of 8",
                   "epochs": 1},
          "stage_s": {"train_s": round(train_s, 3),
                      "outputs_s": round(outputs_s, 3)},
          "steps": len(vlosses), "loss_first_last": [vlosses[0], vlosses[-1]],
          **{k: res[k] for k in SERVE_REPORT}})
    del params
    torch.cuda.empty_cache()
    arms = {**{(r, p): baseline[(r, p)] for r, p in
               (("fp32", "lru"), ("fp32", "recmg"), ("int8", "lru"),
                ("int8", "recmg"))}, **summary}
    emit({"phase": "learned_vs_frequency", "arms": {
        f"{r} {'recmg-frequency' if p == 'recmg' else p}": {
            k: arms[(r, p)][k] for k in ("hit_rate", "on_demand_rows",
                                         "prefetch_hits", "p50_batch_ms",
                                         "model_s")}
        for r, p in arms}})
    return launches, kept



# ---------------------------------------------------------------------------
# Phases 9' and 9'': the pipelined runtime, admission and drift adaptation.
# ---------------------------------------------------------------------------

RUNTIME_COUNTERS = ("batches", "lookups", "hits", "prefetch_hits",
                    "on_demand_rows", "evictions")
RUNTIME_PATH = ("gather_rows_expand", "gather_rows_dequant_expand",
                "quantize_scatter", "lstm_cell")


class ThreadLaunches:
    """Splits ``quantize_scatter``'s launches by the thread that made them,
    so a run can show that the prefetch engine's worker launched the
    kernel.  It wraps the store's entry point ``ops.quantize_scatter``; the
    kernel's own ``launches`` count still counts every launch."""

    def __init__(self):
        self.by_thread = {}

    def __enter__(self):
        orig = self._orig = ops.quantize_scatter

        def counted(*a, **kw):
            n0 = eg.quantize_scatter.launches
            out = orig(*a, **kw)
            name = threading.current_thread().name
            self.by_thread[name] = (self.by_thread.get(name, 0)
                                    + eg.quantize_scatter.launches - n0)
            return out

        ops.quantize_scatter = counted
        return self

    def __exit__(self, *exc):
        ops.quantize_scatter = self._orig


class DegradedLaunches:
    """Counts the gather launches made inside the store's degraded read
    (``lookup_resident_device``), apart from the lookups' own."""

    def __init__(self):
        self.launches = 0

    def __enter__(self):
        self._orig = TieredEmbeddingStore.lookup_resident_device
        orig, tally = self._orig, self

        def counted(store, ids):
            n0 = eg.gather_rows_expand.launches \
                + eg.gather_rows_dequant_expand.launches
            out = orig(store, ids)
            tally.launches += eg.gather_rows_expand.launches \
                + eg.gather_rows_dequant_expand.launches - n0
            return out

        TieredEmbeddingStore.lookup_resident_device = counted
        return self

    def __exit__(self, *exc):
        TieredEmbeddingStore.lookup_resident_device = self._orig


def path_launches():
    return {fn.__name__: fn.launches for fn in ops.KERNELS
            if fn.__name__ in RUNTIME_PATH}


def runtime_report(res):
    rt = res["runtime"]
    return {**{k: res[k] for k in RUNTIME_COUNTERS},
            "stall_ms": rt["stall_ms"],
            "demand_fetch_ms": rt["demand_fetch_ms"],
            "p50_batch_ms": res["p50_batch_ms"]}


def phase_runtime_parity(cfg, trace, capacity, qcapacity, batch_queries,
                         baseline):
    """The pipelined runtime at full width against the synchronous serve
    of phase ``serve`` (``baseline``): fp32 ``recmg`` (frequency) and int8
    ``lru`` through the inline scheduler at depths 1 and 2 give the same
    counters, the whole demand fetch stalls at depth 1 and strictly less at
    depth 2; then int8 ``recmg`` (frequency) through the thread scheduler,
    whose counters keep the identities and whose worker launched
    ``quantize_scatter``.  Returns the kernels' launches summed over the
    runs."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    int8 = dict(quantize=True, row_format="int8")
    freq = {capacity: frequency_outputs(trace, capacity),
            qcapacity: frequency_outputs(trace, qcapacity)}
    total = {}
    runs = [("fp32", "recmg", capacity, {}, "inline", 1),
            ("fp32", "recmg", capacity, {}, "inline", 2),
            ("int8", "lru", qcapacity, int8, "inline", 1),
            ("int8", "lru", qcapacity, int8, "inline", 2),
            ("int8", "recmg", qcapacity, int8, "thread", 2)]
    for rows, policy, cap, kw, sched, depth in runs:
        sync = baseline[(rows, policy)]
        outputs = freq[cap] if policy == "recmg" else None
        ops.reset_launches()
        with ThreadLaunches() as threads:
            res = serve_trace(cfg, params, trace, cap, policy, outputs,
                              batch_queries=batch_queries, device="cuda",
                              async_prefetch=True, pipeline_depth=depth,
                              scheduler=sched, collect_logits=True, **kw)
        n = path_launches()
        for name, k in n.items():
            total[name] = total.get(name, 0) + k
        rt = res["runtime"]
        what = f"runtime_parity ({rows}, {policy}, {sched}, depth {depth})"
        require(np.isfinite(res["logits"]).all()
                and res["logits"].shape == (res["batches"], batch_queries),
                f"{what}: logits not finite or of the wrong shape")
        # The demand fetch is the store's modeled fetch (rounded to 0.1 ms
        # in ``modeled_fetch_s``).
        require(abs(rt["demand_fetch_ms"] - res["modeled_fetch_s"] * 1e3)
                <= 0.051, f"{what}: demand fetch {rt['demand_fetch_ms']} ms "
                          f"is not the store's {res['modeled_fetch_s']} s")
        worker = sum(v for t, v in threads.by_thread.items()
                     if t == "prefetch-engine")
        if sched == "inline":
            diff = {k: (sync[k], res[k]) for k in RUNTIME_COUNTERS
                    if sync[k] != res[k]}
            require(not diff, f"{what}: counters differ from the "
                              f"synchronous serve: {diff}")
            if depth == 1:
                require(rt["stall_ms"] == rt["demand_fetch_ms"],
                        f"{what}: stall {rt['stall_ms']} != demand fetch "
                        f"{rt['demand_fetch_ms']}")
            else:
                require(rt["stall_ms"] < rt["demand_fetch_ms"],
                        f"{what}: stall {rt['stall_ms']} not below demand "
                        f"fetch {rt['demand_fetch_ms']}")
        else:
            require(res["hits"] + res["misses"] == res["lookups"]
                    == sync["lookups"] and res["batches"] == sync["batches"]
                    and rt["batches"] == res["batches"]
                    and rt["stall_ms"] < rt["demand_fetch_ms"],
                    f"{what}: accounting identities fail")
            require(worker > 0, f"{what}: the engine's worker launched "
                                "quantize_scatter 0 times")
        emit({"phase": "runtime_parity", "rows": rows, "policy": policy,
              "scheduler": sched, "pipeline_depth": depth,
              "counters_equal_sync": sched == "inline",
              "quantize_scatter_by_worker": worker,
              **runtime_report(res),
              "sync_p50_batch_ms": sync["p50_batch_ms"],
              "pf_issued": rt["pf_issued"], "launches": n})
    del params
    torch.cuda.empty_cache()
    return total


def phase_runtime_serve(cfg, trace, per_batch, capacity, qcapacity,
                        batch_queries, model):
    """The runtime's other paths at full width: ``--overload 2`` on the
    int8 store (degraded reads on the card), ``--adapt`` with the
    frequency model and with the learned model of phase ``learned_serve``
    on a drift workload (3 batches of the diurnal regime, one hot-set
    switch a batch), and ``--workload zipf_hot`` through the CLI's
    ``main``.  Returns the kernels' launches summed over the runs."""
    params = init_dlrm(cfg, seed=0, device="cuda")
    total = {}

    def count(n):
        for name, k in n.items():
            total[name] = total.get(name, 0) + k

    ops.reset_launches()
    with DegradedLaunches() as deg:
        res = serve_trace(cfg, params, trace, qcapacity, "lru",
                          None, batch_queries=batch_queries, device="cuda",
                          async_prefetch=True, overload=2.0, quantize=True,
                          row_format="int8", collect_logits=True)
    n = path_launches()
    count(n)
    adm = res["admission"]
    require(adm["degraded_rows_stale"] > 0,
            "runtime_serve (overload): no stale degraded rows")
    require(deg.launches > 0 and n["gather_rows_dequant_expand"] > 0,
            "runtime_serve (overload): the degraded read launched "
            "gather_rows_dequant_expand 0 times")
    require(adm["admitted"] == adm["served"] + adm["shed"]
            + adm["degraded"] and np.isfinite(res["logits"]).all(),
            "runtime_serve (overload): bad result")
    emit({"phase": "runtime_serve", "run": "overload 2.0, int8 lru",
          **runtime_report(res), "admission": adm,
          "goodput_rps": res["goodput_rps"],
          "offered_rps": res["offered_rps"],
          "degraded_read_launches": deg.launches, "launches": n})

    # Seconds of each fine-tune and output recompute of the learned
    # controller's refreshes (instance wrappers, removed after the run).
    refresh_s = {"finetune": [], "outputs_for": []}

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            refresh_s[key].append(round(time.perf_counter() - t, 3))
            return out
        return run

    drift = make_trace(scenario(
        "diurnal", n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=3 * per_batch, seed=0, n_phases=3))
    adapt_cfg = DriftConfig(window=per_batch, hot_k=256, warmup_windows=1)
    for arm in ("frequency", "learned"):
        ops.reset_launches()
        t0 = time.perf_counter()
        if arm == "learned":
            outputs = model.outputs_for(drift)
        else:
            outputs = frequency_outputs(drift, capacity)
        outputs_s = time.perf_counter() - t0
        n_outputs = path_launches()
        count(n_outputs)
        ops.reset_launches()  # the serve's count: refreshes included
        if arm == "learned":
            model.finetune = timed(model.finetune, "finetune")
            model.outputs_for = timed(model.outputs_for, "outputs_for")
        t0 = time.perf_counter()
        res = serve_trace(cfg, params, drift, capacity, "recmg", outputs,
                          batch_queries=batch_queries, device="cuda",
                          async_prefetch=True, adapt=True,
                          adapt_cfg=adapt_cfg,
                          model=model if arm == "learned" else None,
                          collect_logits=True)
        serve_s = time.perf_counter() - t0
        if arm == "learned":
            del model.finetune, model.outputs_for
        n = path_launches()
        count(n)
        d = res["drift"]
        require(d["refreshes"] > 0, f"runtime_serve (adapt, {arm}): no "
                                    "refresh")
        if arm == "learned":
            require(d["finetunes"] > 0 and n["lstm_cell"] > 0,
                    "runtime_serve (adapt, learned): no fine-tune or no "
                    "lstm_cell launch")
        require(np.isfinite(res["logits"]).all(),
                f"runtime_serve (adapt, {arm}): logits not finite")
        emit({"phase": "runtime_serve", "run": f"adapt, {arm}, fp32 recmg",
              "workload": "diurnal, n_phases=3, 3 batches",
              **runtime_report(res), "drift": d,
              "seconds": {"outputs_before_serve_s": round(outputs_s, 3),
                          "serve_s": round(serve_s, 3),
                          **({"refresh_finetune_s": refresh_s["finetune"],
                              "refresh_outputs_for_s":
                                  refresh_s["outputs_for"]}
                             if arm == "learned" else {})},
              "launches_outputs_before_serve": n_outputs, "launches": n})
    del drift

    ops.reset_launches()
    res = cli_main(["--policy", "recmg", "--model", "frequency",
                    "--workload", "zipf_hot", "--async-prefetch"])
    n = path_launches()
    count(n)
    require(res["hits"] + res["misses"] == res["lookups"] > 0
            and n["gather_rows_expand"] > 0,
            "runtime_serve (--workload zipf_hot): bad result")
    emit({"phase": "runtime_serve", "run": "cli --workload zipf_hot "
          "--async-prefetch (reduced config)", **runtime_report(res),
          "launches": n})
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Phases 10-12: dense-LM serving (flash_attention, tiered vocab rows).
# ---------------------------------------------------------------------------

def phase_flash_kernels(timer):
    """``flash_attention`` against its plain version at ``FLASH_SHAPES``,
    each timed beside its bound and beside SDPA.  Returns the record of
    the serve prefill shape."""
    main = None
    for name, b, s, h, n_kv, hd, dt_name in FLASH_SHAPES:
        dt = DTYPES[dt_name]
        g = torch.Generator(device="cuda").manual_seed(s + hd)
        q, k, v = (torch.randn((b, s, n, hd), generator=g, device="cuda")
                   .to(dt) for n in (h, n_kv, n_kv))
        got = fa.flash_attention(q, k, v)
        want = ref.causal_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulps(got, want) if dt_name == "bf16" else None
        tol = 1e-5 if dt_name == "fp32" else 1e-2
        require(torch.allclose(got.float(), want.float(), rtol=tol,
                               atol=tol),
                f"flash_attention {name} {dt_name}: max abs err {err}")
        del got, want
        # SDPA takes (B, H, S, hd): transposed once, outside the timing.
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - ref.causal_attention_ref(q, k, v).float())
                        .abs().max())
        rec = {"phase": "kernel", "name": "flash_attention", "shape": name,
               "dtype": dt_name, "B": b, "S": s, "H": h, "K": n_kv, "hd": hd,
               "max_abs_err": err, "tolerance": tol,
               **({"max_err_bf16_ulps": ulps} if ulps is not None else {}),
               "design": FLASH_DESIGN[dt_name],
               "library_max_abs_err": lib_err,
               "ms": timer(lambda: fa.flash_attention(q, k, v)),
               "plain_ms": timer(lambda: ref.causal_attention_ref(q, k, v)),
               "library_ms": timer(sdpa)}
        # Causal work: 2 products of 2 * (S^2 / 2) * hd per (batch, head);
        # q, k, v read once and o written once.
        n_bytes = q.element_size() * b * s * hd * (2 * h + 2 * n_kv)
        n_ops = 2 * 2 * b * h * s * s / 2 * hd
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n_bytes, n_ops,
            BF16_OPS_PER_S if dt_name == "bf16" else FP32_OPS_PER_S)
        achieved(rec, n_ops)
        emit(rec)
        if main is None:
            main = rec
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return main


def phase_lm_parity():
    """Full-width smollm-135m from the same parameters on both devices: a
    B=2, S=256 prefill and 8 teacher-forced decode steps, fp32 and bf16."""
    full = get_config("smollm-135m")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, full.vocab, (2, 256 + 8)))
    cfg32 = dataclasses.replace(full, param_dtype="float32",
                                compute_dtype="float32")
    base = init_lm(cfg32, seed=0, device="cpu")
    out = {}
    for dt_name, tol in (("fp32", 1e-4), ("bf16", 5e-2)):
        cfg = cfg32 if dt_name == "fp32" else full
        cpu = base if dt_name == "fp32" else copy.deepcopy(base).to(
            torch.bfloat16)
        logits = {}
        for dev, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to(
                "cuda"))):
            ops.reset_launches()
            lg, cache = prefill(model, cfg, tokens[:, :256].to(dev),
                                cache_len=256 + 8)
            steps = [lg]
            for i in range(8):
                lg, cache = decode_step(model, cfg,
                                        tokens[:, 256 + i:257 + i].to(dev),
                                        cache)
                steps.append(lg)
            logits[dev] = torch.stack(steps).cpu()
            if dev == "cuda":
                require(fa.flash_attention.launches == full.n_layers,
                        f"lm_parity {dt_name}: {fa.flash_attention.launches}"
                        f" flash_attention launches, expected "
                        f"{full.n_layers}")
            del model, cache
        diff = (logits["cuda"] - logits["cpu"]).abs()
        out[dt_name] = {"max_abs_err": float(diff.max()), "tolerance": tol,
                        # The largest |diff| / (atol + rtol |cpu|): the
                        # share of its bound the worst logit uses.
                        "worst_share_of_bound": float(
                            (diff / (tol + tol * logits["cpu"].abs()))
                            .max()),
                        "max_abs_logit": float(logits["cpu"].abs().max()),
                        "argmax_equal_share": float(
                            (logits["cuda"].argmax(-1)
                             == logits["cpu"].argmax(-1)).float().mean())}
        require(bool(torch.isfinite(logits["cuda"]).all()),
                f"lm_parity {dt_name}: non-finite logits on the card")
        require(torch.allclose(logits["cuda"], logits["cpu"], rtol=tol,
                               atol=tol),
                f"lm_parity {dt_name}: card vs CPU logits {out[dt_name]}")
    emit({"phase": "lm_parity", "arch": full.name, "B": 2, "S": 256,
          "decode_steps": 8, "teacher_forced": True, **out})
    torch.cuda.empty_cache()


def phase_lm_serve():
    """The LM serving path at full width; counts set to 0 just before the
    serve and read just after.  Returns the kernels' launches."""
    cfg = get_config("smollm-135m")
    b, prompt_len, steps = 8, 2048, 64
    # The path's own peak: device bytes above what earlier phases left
    # allocated, from the model's weights through the serve.
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, seed=0, device="cuda")
    ops.reset_launches()
    res = serve_lm_tiered(cfg, batch=b, prompt_len=prompt_len, steps=steps,
                          capacity_frac=0.1, policy="lru", device="cuda",
                          seed=0, model=model, collect_logits=True)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS
                if fn.launches}
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    require(launches.get("flash_attention") == cfg.n_layers,
            f"lm_serve: flash_attention launched {launches} (expected "
            f"{cfg.n_layers}, one per prefill layer)")
    require(launches.get("gather_rows_expand") == steps,
            f"lm_serve: gather_rows_expand launched {launches} (expected "
            f"{steps}, one per decode step)")
    require(res["hits"] + res["misses"] == res["lookups"] == b * steps,
            "lm_serve: hits + misses != lookups")
    lg, tok = res["logits"], res["tokens"]
    require(lg.shape == (steps, b, cfg.vocab) and np.isfinite(lg).all()
            and tok.shape == (steps, b) and (tok >= 0).all()
            and (tok < cfg.vocab).all(), "lm_serve: bad logits or tokens")
    # The tiered path's first step against the token path on the same
    # prompt: the cast store rows are the token's embedding, so the two
    # agree bit for bit.
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (b, prompt_len))
    pt = torch.from_numpy(prompt).to("cuda")
    _, cache = prefill(model, cfg, pt, prompt_len + steps)
    ref_logits, _ = decode_step(model, cfg, pt[:, -1:], cache)
    require(np.array_equal(ref_logits.cpu().numpy(), lg[0]),
            "lm_serve: the tiered first step differs from the token path")
    del cache, pt
    emit({"phase": "lm_serve", "arch": cfg.name, "dtype": cfg.param_dtype,
          "cuts": {"from": "prefill_32k B=32 S=32768", "batch": b,
                   "prompt_len": prompt_len},
          "launches": launches, "peak_device_gb": peak_gb,
          "first_step_equals_token_path": True,
          "profile": lm_profile(cfg, model, b, prompt_len),
          **{k: res[k] for k in ("steps", "capacity", "policy", "batches",
                                 "lookups", "hits", "misses", "hit_rate",
                                 "on_demand_rows", "evictions", "tok_per_s",
                                 "prefill_ms", "decode_ms_p50",
                                 "decode_s")}})
    del model
    torch.cuda.empty_cache()
    return launches


def _device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: its wall ms, the device ms of
    its CUDA kernels and copies (one stream, so they do not overlap), their
    launches, and ``{name: device ms}`` per kernel.  ``None`` when the
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        return None
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "launches": sum(e.count for e in kernels),
            "kernels": {e.key[:80]: e.self_device_time_total / 1e3
                        for e in kernels}}


def _profile_summary(wall_ms, busy_ms, launches, kernels, n):
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms / n, "device_busy_ms": busy_ms / n,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": launches / n,
            "top_kernels_ms": {k: v / n for k, v in top}}


def lm_profile(cfg, model, batch, prompt_len, n_steps=8):
    """Where a served LM's time goes, read from the entry point itself:
    ``serve_lm_tiered`` on ``model`` with no decode step (the prefill, then
    the store built over the host copy of the vocab) and with ``n_steps``
    steps, each under ``torch.profiler``.  A decode step is the difference
    of the two over ``n_steps``."""
    def serve(steps):
        return lambda: serve_lm_tiered(
            cfg, batch=batch, prompt_len=prompt_len, steps=steps,
            capacity_frac=0.1, policy="lru", device="cuda", seed=0,
            model=model)
    setup, full = _device_profile(serve(0)), _device_profile(serve(n_steps))
    if setup is None or full is None:
        return "not measured: the profiler recorded no device time"
    diff = {k: full["kernels"][k] - setup["kernels"].get(k, 0.0)
            for k in full["kernels"]}
    return {"prefill_and_store": _profile_summary(
                setup["wall_ms"], setup["busy_ms"], setup["launches"],
                setup["kernels"], 1),
            "decode_per_step": _profile_summary(
                full["wall_ms"] - setup["wall_ms"],
                full["busy_ms"] - setup["busy_ms"],
                full["launches"] - setup["launches"], diff, n_steps)}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # fp32 products stay fp32 on the card: no TF32 in any comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    timer = Timer()

    full = get_config("dlrm-recmg")
    serve_cfg = dataclasses.replace(full, rows_per_table=4096)
    batch_queries = 32
    per_batch = batch_queries * full.n_tables * full.multi_hot
    trace = generate_trace(TraceGenConfig(
        n_tables=serve_cfg.n_tables, rows_per_table=serve_cfg.rows_per_table,
        n_accesses=8 * per_batch, seed=0, drift_every=10**9))
    capacity = int(0.2 * trace.unique_count())
    # The same fast-tier bytes re-spent as quantized rows (the CLI's
    # --quantize conversion): 185,651 x 512 B / 132 B.
    qcapacity = capacity * fast_row_bytes(full.emb_dim, np.float32, False) \
        // fast_row_bytes(full.emb_dim, np.float32, True, "int8")
    fwd_b = 256

    main_recs = phase_kernels(timer, trace.global_id[:per_batch], capacity,
                              full.n_tables * serve_cfg.rows_per_table,
                              fwd_b, full)
    main_recs.update(phase_quant_kernels(timer, trace,
                                         trace.global_id[:per_batch],
                                         qcapacity, full))
    main_recs.update(phase_learned_kernels(timer))
    main_recs["flash_attention"] = phase_flash_kernels(timer)
    phase_learned_grads()
    phase_parity()
    phase_learned_parity()
    int8 = dict(quantize=True, row_format="int8")
    serve_launches, serve_results, qs_by_store = phase_serve(
        serve_cfg, trace, [
            ("fp32", "lru", capacity, {}),
            ("fp32", "recmg", capacity, {}),
            ("int8", "lru", qcapacity, int8),
            ("int8", "recmg", qcapacity, int8),
            ("fp8", "lru", qcapacity, dict(quantize=True, row_format="fp8")),
            ("int8-multi_table", "lru", qcapacity,
             dict(multi_table=True, **int8)),
        ], batch_queries)
    learned_launches, learned_model = phase_learned_serve(
        serve_cfg, trace, capacity, qcapacity, per_batch, batch_queries,
        serve_results)
    runtime_launches = phase_runtime_parity(serve_cfg, trace, capacity,
                                            qcapacity, batch_queries,
                                            serve_results)
    for name, k in phase_runtime_serve(serve_cfg, trace, per_batch, capacity,
                                       qcapacity, batch_queries,
                                       learned_model).items():
        runtime_launches[name] = runtime_launches.get(name, 0) + k
    del trace, serve_results, learned_model
    pool_rec, pool_launches, qpool_rec, qpool_launches = phase_forward(
        timer, full, fwd_b)
    phase_lm_parity()
    lm_launches = phase_lm_serve()

    kernels = []
    for name, rec, n, src, replaces in (
            ("gather_rows_expand", main_recs["gather_rows_expand"],
             serve_launches["gather_rows_expand"], CU_SOURCE,
             TPU_GATHER_ROWS),
            ("gather_pool", pool_rec, pool_launches, CU_SOURCE,
             TPU_GATHER_POOL),
            ("quantize_scatter", main_recs["quantize_scatter"],
             serve_launches["quantize_scatter"], CU_QUANT_SOURCE,
             TPU_QUANTIZE_ROWS),
            ("gather_rows_dequant_expand",
             main_recs["gather_rows_dequant_expand"],
             serve_launches["gather_rows_dequant_expand"], CU_QUANT_SOURCE,
             TPU_GATHER_ROWS_DEQUANT),
            ("gather_pool_dequant", qpool_rec, qpool_launches,
             CU_QUANT_SOURCE, TPU_GATHER_POOL_DEQUANT),
            ("lstm_cell", main_recs["lstm_cell"],
             learned_launches["lstm_cell"], CU_LSTM_SOURCE, TPU_LSTM_CELL),
            ("chamfer", main_recs["chamfer"], learned_launches["chamfer"],
             CU_CHAMFER_SOURCE, TPU_CHAMFER),
            ("flash_attention", main_recs["flash_attention"],
             lm_launches["flash_attention"], CU_FLASH_SOURCE,
             TPU_FLASH_ATTENTION)):
        # The runtime phases drive the store's kernels and the learned
        # model's fine-tune through their own paths.
        n += runtime_launches.get(name, 0)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if name in REDESIGNED:
            kernels[-1]["design"] = REDESIGNED[name]
        if name in runtime_launches:
            kernels[-1]["launches_runtime"] = runtime_launches[name]
        if name == "quantize_scatter":
            kernels[-1].update(launches_full_batch=qs_by_store["full_batch"],
                               launches_per_table=qs_by_store["per_table"])
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
