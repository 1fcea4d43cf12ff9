"""Model-free scenario serving harness: replay a workload spec through a
tiered store (single-worker or sharded) exactly like ``serve_trace`` does
— same batched lookups, same one-prefetch-set-per-batch Algorithm-1
staging, same optional drift adaptation — but without the DLRM dense
forward or any model training.  That keeps a full scenario matrix cell to
tens of milliseconds, so the regression tests can afford
``regime x policy x shard-count`` and the bench can afford per-scenario
rows.

Ported from ``src/repro/workloads/harness.py``: the replay loop is a
copy.  What changed: the store, and the learned and Voyager models, live
on ``device`` (``"cuda"`` by default; it raises when CUDA is absent), and
``shards > 0`` raises ``NotImplementedError``: the sharded store waits
for ROADMAP A10.

The recmg arm's outputs come from the ``model`` switch: ``"frequency"``
(the deterministic frequency-heuristic stand-in, the default),
``"learned"`` (the trained dual models —
:class:`repro_torch.core.model_runtime.LearnedRecMGModel` trained on the trace
prefix, batched inference on the device, and with ``adapt=True`` the online
fine-tune loop), or ``"voyager"`` (the ML-prefetcher baseline: LRU store
+ Voyager prefetch stream).  ``profile_frac < 1`` freezes the
profile/training on a trace prefix — the frozen-model decay arm of the
drift experiments.

Counters returned here are exactly the store's ``TierStats`` (plus drift
telemetry when ``adapt=True``), so golden files pin the same quantities
as the full ``serve_trace`` goldens.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.tracing import get_tracer
from repro_torch.runtime.drift import AdaptiveController, DriftConfig
from repro_torch.workloads.spec import (WorkloadSpec, iter_batches,
                                        make_trace)

# Deterministic serve metrics a golden file may pin (no wall-clock).
GOLDEN_KEYS = ("regime", "policy", "batches", "lookups", "hits", "hit_rate",
               "prefetch_hits", "on_demand_rows", "evictions",
               "modeled_fetch_ms_per_batch")


def build_store(host: np.ndarray, rows_per_table: np.ndarray, capacity: int,
                policy: str, shards: int = 0, placement: str = "table",
                fetch_us_per_row: float = 10.0,
                quantize: bool = False, row_format: Optional[str] = None,
                warmup_batch: Optional[int] = None, device="cuda"):
    """The same store-selection switch ``serve_trace`` uses: one store on
    ``device``.  ``shards > 0`` (the sharded store) raises."""
    if shards:
        raise NotImplementedError(
            "shards > 0 (the sharded store) is not ported to repro_torch "
            "yet: ROADMAP A10 (sharded + fault path)")
    return TieredEmbeddingStore(
        host, capacity, policy=policy, quantize=quantize,
        row_format=row_format, fetch_us_per_row=fetch_us_per_row,
        warmup_batch=warmup_batch, device=device)



def replay_scenario(spec: WorkloadSpec, policy: str = "lru",
                    capacity_frac: float = 0.12, batch: int = 256,
                    shards: int = 0, placement: str = "table",
                    adapt: bool = False,
                    adapt_cfg: Optional[DriftConfig] = None,
                    profile_frac: float = 1.0, emb_dim: int = 8,
                    capacity: Optional[int] = None,
                    byte_budget: Optional[int] = None,
                    quantize: bool = False,
                    row_format: Optional[str] = None,
                    in_len: int = 15, out_len: int = 5,
                    model: str = "frequency", model_cfg=None,
                    device="cuda") -> Dict:
    """Serve one scenario end to end; returns the metrics dict.

    ``policy`` is ``"lru"`` or ``"recmg"``; ``model`` selects where the
    recmg outputs come from (``"frequency"`` heuristic, ``"learned"``
    trained dual models, or ``"voyager"`` — the prefetch-only baseline,
    served on an LRU store) and ``model_cfg`` optionally overrides the
    :class:`~repro_torch.core.model_runtime.LearnedModelConfig`.  The profile /
    training data is the first ``profile_frac`` of the trace.
    ``adapt=True`` attaches an :class:`AdaptiveController` whose refresh
    items are staged through the same model-output path; with
    ``model="learned"`` the controller additionally fine-tunes the model
    online on every drift refresh
    (:class:`~repro_torch.core.model_runtime.LearnedController`).

    ``byte_budget`` sizes the fast tier in bytes instead of rows
    (mutually exclusive with ``capacity``), converted with the
    quantization-aware per-row footprint — the fixed-byte-budget cells
    (``quantize=True`` holds more rows in the same bytes) compare arms
    through this knob.

    The store and the models live on ``device`` (``"cuda"`` by default;
    it raises when CUDA is absent); ``shards > 0`` raises
    ``NotImplementedError`` (ROADMAP A10).
    """
    dev = resolve_device(device)
    if model not in ("frequency", "learned", "voyager"):
        raise ValueError(f"unknown model {model!r} "
                         "(frequency | learned | voyager)")
    if capacity is not None and byte_budget is not None:
        raise ValueError("pass at most one of capacity / byte_budget")
    trace = make_trace(spec)
    if byte_budget is not None:
        from repro_torch.core.tiered import fast_row_bytes

        cap = max(1, int(byte_budget) // fast_row_bytes(
            emb_dim, np.float32, quantize, row_format or "int8"))
    else:
        cap = int(capacity) if capacity else max(
            4, int(capacity_frac * trace.unique_count()))
    host = np.random.default_rng(0).normal(
        size=(trace.n_vectors, emb_dim)).astype(np.float32)
    store = build_store(host, trace.rows_per_table, cap, policy,
                        shards=shards, placement=placement,
                        quantize=quantize, row_format=row_format,
                        warmup_batch=batch, device=dev)
    upto = int(profile_frac * len(trace)) if profile_frac < 1.0 else None
    outputs = None
    learned = None
    if model == "voyager":
        from repro_torch.core.model_runtime import voyager_outputs

        outputs = voyager_outputs(trace, cap, in_len=in_len,
                                  out_len=out_len, profile_upto=upto,
                                  device=dev)
    elif policy == "recmg":
        if model == "learned":
            from repro_torch.core.model_runtime import LearnedRecMGModel

            learned = LearnedRecMGModel.train_from_trace(
                trace, cap, model_cfg, profile_upto=upto, device=dev)
            outputs = learned.outputs_for(trace)
        else:
            outputs = frequency_outputs(trace, cap, in_len=in_len,
                                        out_len=out_len, profile_upto=upto)
    from repro_torch.core.model_runtime import OutputsRef

    oref = OutputsRef(outputs)

    controller = None
    if adapt:
        if adapt_cfg is None:
            adapt_cfg = DriftConfig(window=max(512, 4 * batch),
                                    hot_k=min(cap, 256))
        if learned is not None:
            from repro_torch.core.model_runtime import LearnedController

            controller = LearnedController(store, cap, learned, oref,
                                           trace, adapt_cfg)
        else:
            controller = AdaptiveController(store, cap, adapt_cfg)

    gid = trace.global_id
    chunk_ptr = 0
    lat, batch_hit_rates = [], []
    empty = np.empty(0, np.int64)
    tr = get_tracer()
    for b, ids in enumerate(iter_batches(spec, batch, trace=trace)):
        if tr.enabled:
            tr.set_batch(b)
        pre_hits = store.stats.hits
        t0 = time.perf_counter()
        store.lookup(ids)
        lat.append(time.perf_counter() - t0)
        hits = store.stats.hits - pre_hits
        batch_hit_rates.append(hits / max(ids.size, 1))
        # Stage the chunks this batch covered — caching ranks for every
        # chunk, prefetches only from the most recent one (serve_trace's
        # one-prefetch-set-per-batch rule, paper Fig. 6).  Outputs are
        # read through ``oref`` so an online refresh (LearnedController)
        # swaps them mid-run; the chunk grid is identical, so the chunk
        # pointer stays valid.
        if oref.outputs is not None:
            out = oref.outputs
            hi = (b + 1) * batch
            last_pf = None
            while (chunk_ptr < len(out.chunk_starts)
                   and out.chunk_starts[chunk_ptr] < hi):
                s = int(out.chunk_starts[chunk_ptr])
                trunk = gid[max(0, s - in_len): s]
                bits = (out.caching_bits[chunk_ptr]
                        if out.caching_bits is not None
                        else np.zeros(len(trunk)))
                store.stage_model_outputs(trunk, bits, empty)
                if out.prefetch_ids is not None:
                    last_pf = out.prefetch_ids[chunk_ptr]
                chunk_ptr += 1
            if last_pf is not None:
                store.stage_model_outputs(empty, empty,
                                          np.asarray(last_pf, np.int64))
        if controller is not None:
            for item in controller.on_batch(ids, hits, b):
                store.stage_model_outputs(*item)
        store.flush_staged()

    res = store.stats.as_dict()
    res.update(
        regime=spec.regime, policy=policy, model=model, capacity=cap,
        n_accesses=len(trace), shards=shards,
        p50_batch_ms=float(np.percentile(lat, 50) * 1e3) if lat else 0.0,
        p95_batch_ms=float(np.percentile(lat, 95) * 1e3) if lat else 0.0,
        modeled_fetch_ms_per_batch=store.modeled_batch_ms(),
        batch_hit_rates=batch_hit_rates,
    )
    if learned is not None:
        res["learned"] = learned.telemetry()
    if controller is not None:
        res["drift"] = controller.as_dict()

    # Same unified registry surface as ``serve_trace``: one namespace the
    # reconciliation checker (and the scenario bench artifact) can read.
    reg = MetricsRegistry()
    store.publish_metrics(reg)
    if controller is not None and hasattr(controller, "publish"):
        controller.publish(reg)
    res["metrics"] = reg.snapshot()
    return res


def golden_metrics(res: Dict) -> Dict:
    """The deterministic subset of a :func:`replay_scenario` result that a
    golden file pins (counters + cost model; no wall-clock, no series)."""
    return {k: res[k] for k in GOLDEN_KEYS}


def phase_steady_hit_rates(res: Dict, n_phases: int) -> np.ndarray:
    """Mean hit rate over the steady (second) half of each of ``n_phases``
    equal phases of a :func:`replay_scenario` result — the pre/post-switch
    comparison the drift tests, the adaptation example and the
    ``adapt_recovery`` bench row all share (one definition, so the
    acceptance bar and the gate measure the same thing)."""
    hr = np.asarray(res["batch_hit_rates"])
    hr = hr[: len(hr) - len(hr) % n_phases].reshape(n_phases, -1)
    return hr[:, hr.shape[1] // 2:].mean(axis=1)
