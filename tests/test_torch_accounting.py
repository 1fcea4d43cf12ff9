"""The dry-run's traced half (``repro_torch.launch.accounting``, the
port's counterpart of JAX's ``launch/hlo_analysis.py``) against what the
port's ranks really do, and its roofline against JAX's, on the CPU.

- **Collectives.** Four ``gloo`` ranks (``tests/torch_accounting_ranks.py``,
  one spawn) run reduced smollm-135m under ``fsdp_tp`` and trained split
  under ``fsdp_seq``, granite-moe, falcon-mamba-7b, whisper-large-v3 and
  DLRM under ``emb_rows="all"`` on (2, 2): a train step, a prefill and a
  decode step each (DLRM: a train step and its served forward).  Each
  rank's recorded collectives (calls and result bytes of each kind) equal
  the accountant's trace of that rank on the ``meta`` device, exactly.
- **FLOPs.** A reduced dense LM's train step on one rank: ``dot_flops``
  equals the closed form 6 T (L (projections + MLP) + head) plus the
  attention's 4 + 10 operations a visible (query, key) pair and head dim.
- **Scaling.** The counts fitted from 2-3 layers and 2-3 microbatches, and
  the peak from the depth's own trace, equal a whole trace at 4 layers x
  4 microbatches (the smallest cell where both fits engage; the issue's
  2 x 2 is traced whole), train, prefill and decode, under ``fsdp_tp``
  and ``fsdp_seq``.
- **Fold.** Every multi-pod cell lays out each parameter, batch and cache
  leaf as (data 32, model 16) does with ``pod`` folded into ``data``.
- **Roofline.** ``roofline_row`` of a hand-made cell gives the terms
  worked out by hand, and JAX's ``roofline_row`` (its constants set to
  the H100's, its XLA keys fed the port's counts) the same row;
  ``fmt_s`` and ``to_markdown`` print as JAX's.
- **Full size.** A full-size 16x16 cell traces within 60 s; the CLI
  writes the traced keys on both meshes.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_accounting_ranks as ranks
from repro.launch import roofline as jax_roofline
from repro_torch.configs import (ALL_ARCHS, RunConfig, get_config,
                                 shapes_for)
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.compression import psum_int8
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import work as W
from repro_torch.launch import accounting as A
from repro_torch.launch import dryrun, roofline
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import global_norm
from repro_torch.sharding import partition as SP
from repro_torch.tree import named_leaves

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rank_records(tmp_path_factory):
    work = tmp_path_factory.mktemp("accounting")
    mp.spawn(ranks.rank_main, args=(4, str(work)), nprocs=4, join=True)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("case,kind", [(c, p) for c in ranks.CASES
                                       for p in ranks.passes(c)])
def test_traced_collectives_equal_each_ranks_record(rank_records, case,
                                                    kind):
    for r, rec in enumerate(rank_records):
        real = dict(zip(ranks.KEYS, rec[f"{case}/{kind}/real"].tolist()))
        traced = dict(zip(ranks.KEYS, rec[f"{case}/{kind}/traced"].tolist()))
        assert real == traced, (case, kind, r)
        assert real["collective_bytes"] > 0, (case, kind, r)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b"])
def test_dot_flops_equal_the_closed_form(arch):
    cfg = get_config(arch).reduced()
    b, s = 2, 16
    acc = A.account(cfg, ShapeConfig("t", "train", s, b),
                    RunConfig(remat="none"), {"data": 1, "model": 1})
    d, h, kv, hd, f, v, n = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                             cfg.d_ff, cfg.vocab, cfg.n_layers)
    proj = d * h * hd + 2 * d * kv * hd + h * hd * d
    pairs = s * (s + 1) // 2  # causal: query i sees i + 1 keys
    want = 6 * b * s * (n * (proj + 3 * d * f) + d * v) \
        + n * (4 + 10) * b * h * hd * pairs
    assert acc["cost"]["dot_flops"] == want
    assert acc["kernels"]["flash_attention"]["calls"] == n
    assert acc["kernels"]["flash_attention_bwd"]["calls"] == n


SCALED = [("qwen2.5-3b", "train", "fsdp_tp"),
          ("granite-moe-1b-a400m", "train", "fsdp_seq"),
          ("whisper-large-v3", "train", "fsdp_tp"),
          ("hymba-1.5b", "prefill", "fsdp_tp"),
          ("qwen2.5-3b", "prefill", "fsdp_tp"),
          ("falcon-mamba-7b", "decode", "fsdp_seq")]


@pytest.mark.parametrize("arch,kind,sharding", SCALED)
def test_fitted_counts_equal_a_whole_trace(arch, kind, sharding):
    cfg = get_config(arch).reduced()
    kw = {"n_layers": 4}
    if cfg.enc_dec:
        kw["n_enc_layers"] = 4
    cfg = dataclasses.replace(cfg, **kw)
    mb = 4 if kind == "train" else 1
    shape = ShapeConfig("t", kind, 16, 8 if kind == "train" else 4)
    run = RunConfig(sharding=sharding)
    mesh = M.virtual_mesh(2, 2, 3)
    fit = A.fitted(cfg, shape, run, mesh, mb)
    whole = A.trace_step(cfg, shape, run, mesh, mb)
    assert len(fit["traced"]) > 1  # the fit engaged
    assert fit["counts"] == whole["counts"]
    assert fit["bounded"] == whole["bounded"]


def test_multi_pod_cells_fold_into_data_32():
    pod = dryrun.MESHES["2x16x16"]
    folded = A.folded(pod)
    assert folded == {"data": 32, "model": 16}
    run = RunConfig()
    for arch in ALL_ARCHS:
        bundle = build(get_config(arch), device="meta")
        model = bundle.param_struct()
        for shape in shapes_for(bundle.cfg).values():
            batch = bundle.batch_struct(shape)
            cache = (bundle.cache_struct(shape) if shape.kind == "decode"
                     else None)
            assert A.fold_differences(model, batch, cache, run, pod) == [], (
                arch, shape.name)
            for dims, _ in batch.values():
                assert SP.shard_shape(dims, SP.batch_spec(dims, pod), pod) \
                    == SP.shard_shape(dims, SP.batch_spec(dims, folded),
                                      folded)
        a, b = (SP.param_specs(model, m) for m in (pod, folded))
        for name, t in named_leaves(model):
            assert SP.shard_shape(t.shape, a[name], pod) == SP.shard_shape(
                t.shape, b[name], folded), (arch, name)
    # A dim that 2 divides and 32 does not lies over pod alone: no fold.
    odd = {"emb": torch.empty((2, 34, 4), device="meta")}
    assert A.fold_differences(odd, {}, None, run, pod) == ["param emb"]


def _cell(kind="train"):
    return {"status": "ok", "arch": "smollm-135m", "shape": "train_4k",
            "mesh": "16x16", "kind": kind, "devices": 256,
            "microbatches": 16, "param_bytes_per_device": 1_000_000,
            "argument_bytes_per_device": 3_000_000_000,
            "cost": {"dot_flops": 989e12 * 0.5, "bytes_accessed": 3.35e12},
            "collectives": {"collective_bytes": 50e9 * 0.25},
            "memory_analysis": {"argument_size_in_bytes": 3e9,
                                "output_size_in_bytes": 2e9,
                                "temp_size_in_bytes": 5e9,
                                "alias_size_in_bytes": 2e9}}


def test_roofline_row_by_hand():
    row = roofline.roofline_row(_cell())
    assert row["compute_s"] == pytest.approx(0.5)
    assert row["memory_s"] == pytest.approx(1.0)
    assert row["collective_s"] == pytest.approx(0.25)
    assert row["dominant"] == "memory" and row["bound_step_s"] == \
        pytest.approx(1.0)
    mf = roofline.model_flops(_cell())
    assert row["useful_ratio"] == pytest.approx(mf / (989e12 * 0.5 * 256))
    assert row["roofline_fraction"] == pytest.approx(mf / (256 * 989e12))
    assert row["hbm_gb_per_dev"] == pytest.approx(8.0)
    assert roofline.roofline_row({**_cell(), "status": "skipped"}) is None


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_roofline_row_matches_jax(monkeypatch, kind):
    for name, value in (("PEAK_FLOPS", roofline.PEAK_FLOPS),
                        ("HBM_BW", roofline.HBM_BW),
                        ("ICI_BW", roofline.LINK_BW)):
        monkeypatch.setattr(jax_roofline, name, value)
    cell = _cell(kind)
    cell["shape"] = "decode_32k" if kind == "decode" else "train_4k"
    jcell = {**cell, "cost_analysis": {
        "flops": cell["cost"]["dot_flops"],
        "bytes accessed": cell["cost"]["bytes_accessed"]},
        "collectives": {**cell["collectives"],
                        "hlo_dot_flops": cell["cost"]["dot_flops"]}}
    mine, want = roofline.roofline_row(cell), jax_roofline.roofline_row(jcell)
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_ratio", "roofline_fraction",
                "bound_step_s", "hbm_gb_per_dev"):
        assert mine[key] == pytest.approx(want[key]), key
    assert roofline.to_markdown([mine]) == jax_roofline.to_markdown([mine])
    for x in (3.2, 1.0, 0.5, 2e-3, 1e-3, 4e-5, 0.0):
        assert roofline.fmt_s(x) == jax_roofline.fmt_s(x)


def test_visible_pairs_count_the_mask():
    for sq, sk, window, causal, off in ((16, 16, 0, True, 0),
                                        (16, 16, 5, True, 0),
                                        (8, 32, 0, True, 24),
                                        (8, 32, 6, True, 12),
                                        (8, 32, 40, True, 20),
                                        (7, 9, 0, False, 0)):
        q = np.arange(off, off + sq)[:, None]
        k = np.arange(sk)[None, :]
        mask = np.ones((sq, sk), bool) if not causal else (k <= q) & (
            (k > q - window) if window else True)
        assert W.visible_pairs(sq, sk, window, causal, off) == mask.sum()


def test_meta_takes_the_kernels_route_and_cpu_the_plain():
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    meter = A.Meter()
    with W.metering(meter):
        out = ops.flash_attention(q, k, k)
        assert meter.kernels == {}  # the CPU ran the plain version
        torch.testing.assert_close(out, ref.causal_attention_ref(q, k, k))
        mo = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert mo.device.type == "meta" and mo.shape == q.shape
    assert meter.kernels["flash_attention"] == {
        "calls": 1, "ops": W.flash_attention(1, 8, 8, 2, 1, 16, 4).ops,
        "bytes": W.flash_attention(1, 8, 8, 2, 1, 16, 4).bytes}
    assert ops.flash_attention.__module__ == "repro_torch.kernels.ops"
    from repro_torch.kernels import flash_attention as fa
    assert fa.flash_attention.launches == 0  # nothing launched


def test_every_collective_is_recorded_on_a_virtual_mesh():
    mesh = M.virtual_mesh(2, 2, 3)
    x = torch.empty((4, 8), device="meta")
    C.reset_record()
    C.reset_traffic()
    assert M.gather_batch(x, mesh).shape == (8, 8)
    C.all_reduce_max(x, mesh.model_group)
    psum_int8([torch.empty((4,), dtype=torch.int8, device="meta")],
              [torch.empty((), device="meta")], mesh.data_group, 2)
    p = torch.empty((4, 8), device="meta")
    p.placement = M.Placement(mesh, ("data",), "fsdp_tp")
    global_norm([p], [p])
    stats = C.collective_stats()
    assert stats["count_all-gather"] == 1
    assert stats["bytes_all-gather"] == 8 * 8 * 4
    # max (4, 8) fp32, codes (4,) int32, scale, the norm's part: twice each
    assert stats["count_all-reduce"] == 4
    assert stats["bytes_all-reduce"] == 2 * (128 + 16 + 4 + 4)
    assert C.TRAFFIC["all_reduce"]["calls"] == 4
    assert C.TRAFFIC["all_gather"]["bytes"] == 256
    with pytest.raises(ValueError, match="meta"):
        C.all_reduce_(torch.zeros(2), mesh.data_group)


def test_a_full_size_cell_traces_within_60_s():
    t0 = time.perf_counter()
    cell = dryrun.lower_cell("qwen2.5-3b", "train_4k", False, RunConfig())
    assert time.perf_counter() - t0 < 60
    assert cell["status"] == "ok" and cell["traced_rank"] == 15
    assert cell["cost"]["dot_flops"] > 0 and \
        cell["collectives"]["collective_bytes"] > 0
    assert cell["memory_analysis"]["temp_size_in_bytes"] > 0
    assert cell["bounded"] == ["models/transformer.py::_EmbedRows.backward"]
    assert roofline.roofline_row(cell)["dominant"] in (
        "compute", "memory", "collective")


def test_dryrun_cli_writes_the_traced_keys(tmp_path):
    assert dryrun.main(["--arch", "falcon-mamba-7b", "--shape",
                        "decode_32k", "--mesh", "both", "--out",
                        str(tmp_path), "--tag", "t"]) == 0
    for mesh in ("16x16", "2x16x16"):
        cell = json.loads((tmp_path / "t" / f"falcon-mamba-7b__decode_32k__"
                           f"{mesh}.json").read_text())
        assert cell["status"] == "ok"
        for key in ("collectives", "cost", "memory_analysis", "bounded"):
            assert key in cell, (mesh, key)
    assert "traced_as" in cell
    rows = roofline.main(["--dir", str(tmp_path), "--tag", "t",
                          "--mesh", ""])
    assert len(rows) == 2
