"""DLRM serving launcher on tiered memory, in PyTorch on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy lru

Ported from ``src/repro/launch/serve.py``: the synchronous path, through
one store or the per-table facade (``--multi-table``), with fp32 or
quantized (``--quantize [--row-format fp8]``) fast-tier rows.  Pipeline per
inference batch (paper Fig. 6):
  1. embedding lookups go through the TieredEmbeddingStore (device buffer
     backed by the host-tier table; one fused CUDA gather per batch, one
     per table hit under ``--multi-table``);
  2. the rows are sum-pooled and the DLRM dense forward runs on the device;
  3. between batches, the RecMG model outputs for the *previous* chunk are
     staged and applied (Algorithm 1), pipelined one batch ahead.

The recmg model outputs come from the trained dual models (``--model
learned``, the default: both models train on the trace on the device,
every LSTM step through the CUDA ``lstm_cell`` kernel and the prefetch
loss through the CUDA ``chamfer`` kernel), the frequency heuristic
(``--model frequency``) or the Voyager baseline (``--model voyager``, a
prefetch stream on an LRU store); ``--policy recmg-oracle`` serves the
chunk grid with no model outputs.

The host table, the trace and the dense inputs come from the same NumPy
draws as in the JAX launcher, so the counters are the same.  The CLI keeps
the JAX launcher's flags and defaults; a flag whose subsystem is not ported
yet raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.model_runtime import (LearnedModelConfig,
                                            LearnedRecMGModel, OutputsRef,
                                            voyager_outputs)
from repro_torch.core.recmg import (RecMGOutputs, frequency_outputs,
                                    precompute_outputs)
from repro_torch.core.serving import MultiTableTieredStore
from repro_torch.core.tiered import TieredEmbeddingStore, fast_row_bytes
from repro_torch.core.trace import Trace, TraceGenConfig, generate_trace
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.dlrm import _mlp, init_dlrm, interact_top, torch_dtype
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.tracing import get_tracer


def serve_trace(cfg, params, trace: Trace, capacity: int, policy: str,
                outputs: Optional[RecMGOutputs], batch_queries: int = 64,
                fetch_us_per_row: float = 10.0, multi_table: bool = False,
                quantize: bool = False, row_format: Optional[str] = None,
                log=None, device="cuda", collect_logits: bool = False
                ) -> Dict:
    """Replay a trace as DLRM inference batches through the tiered store.

    ``quantize=True`` stores the fast tier quantized (``row_format``:
    ``"int8"`` default or ``"fp8"``) with per-row fp32 scales — ``D + 4``
    bytes per resident row instead of ``D * 4`` (``capacity`` here is
    still in rows; the CLI's ``--quantize`` converts the byte budget
    implied by ``--capacity-frac`` into the larger quantized row count).

    ``multi_table=True`` serves through the per-table facade (one batched
    store per sparse feature under the shared row budget) instead of one
    monolithic store; the result gains ``per_table_hit_rates``.

    ``params`` must live on ``device`` (``"cuda"`` by default; it raises
    when CUDA is absent).  ``collect_logits=True`` adds ``"logits"``, the
    (batches, batch_queries) fp32 outputs, copied to the host after each
    batch's timed window."""
    dev = resolve_device(device)
    T, P = cfg.n_tables, cfg.multi_hot
    per_batch = batch_queries * T * P
    host_rows = int(trace.rows_per_table.sum())
    host = np.random.default_rng(0).normal(
        size=(host_rows, cfg.emb_dim)).astype(np.float32)
    pol = "recmg" if policy == "recmg" else "lru"
    # The warm-up (kernel library load and one launch at the batch's size)
    # runs at construction, off the measured path.
    if multi_table:
        store = MultiTableTieredStore.from_global_table(
            host, trace.rows_per_table, capacity=capacity, policy=pol,
            quantize=quantize, row_format=row_format,
            fetch_us_per_row=fetch_us_per_row, warmup_batch=per_batch,
            device=dev)
    else:
        store = TieredEmbeddingStore(
            host, capacity, policy=pol, quantize=quantize,
            row_format=row_format, fetch_us_per_row=fetch_us_per_row,
            warmup_batch=per_batch, device=dev)

    gid = trace.global_id
    rng = np.random.default_rng(1)
    n_batches = len(gid) // per_batch
    chunk_state = {"ptr": 0}
    compute = {"s": 0.0}
    logits = []
    oref = OutputsRef(outputs)

    def staged_for_batch(b):
        """Model outputs to stage after batch ``b``: caching priorities for
        every chunk the batch covered, but prefetches only from the most
        recent one — the paper issues ONE prefetch set per inference batch
        (Fig. 6); flooding every chunk's PO would churn the buffer."""
        out = oref.outputs
        if out is None:
            return []
        items, last_pf = [], None
        hi = (b + 1) * per_batch
        empty = np.empty(0, np.int64)
        ptr = chunk_state["ptr"]
        while (ptr < len(out.chunk_starts)
               and out.chunk_starts[ptr] < hi):
            s = int(out.chunk_starts[ptr])
            trunk = gid[max(0, s - 15): s]
            bits = (out.caching_bits[ptr]
                    if out.caching_bits is not None
                    else np.zeros(len(trunk)))
            items.append((trunk, bits, empty))
            if out.prefetch_ids is not None:
                last_pf = out.prefetch_ids[ptr]
            ptr += 1
        chunk_state["ptr"] = ptr
        if last_pf is not None:
            items.append((empty, empty, np.asarray(last_pf, np.int64)))
        return items

    def forward_batch(emb):
        """Pool + dense forward; returns the logits (on the device) and
        adds the measured compute seconds."""
        emb = emb.reshape(batch_queries, T, P, cfg.emb_dim).sum(dim=2)
        dense = torch.from_numpy(
            rng.normal(size=(batch_queries, cfg.dense_features))
            .astype(np.float32)).to(dev)
        t1 = time.perf_counter()
        out = _dense_forward(params, cfg, dense, emb)
        synchronize(dev)
        compute["s"] += time.perf_counter() - t1
        return out

    # Warm the dense forward off the measured path: the first call pays
    # the CUDA library and allocator set-up.
    _dense_forward(params, cfg,
                   torch.zeros((batch_queries, cfg.dense_features),
                               device=dev),
                   torch.zeros((batch_queries, T, cfg.emb_dim), device=dev))
    synchronize(dev)

    lat = []
    _tr = get_tracer()
    for b in range(n_batches):
        if _tr.enabled:
            _tr.set_batch(b)
        ids = gid[b * per_batch: (b + 1) * per_batch]
        t0 = time.perf_counter()
        emb = store.lookup(ids)  # (per_batch, D)
        out = forward_batch(emb)
        lat.append(time.perf_counter() - t0)
        if collect_logits:
            logits.append(out.float().cpu().numpy())
        # ``stage_model_outputs`` double-buffers: the outputs land at the
        # next batch boundary without blocking an in-flight lookup; the
        # flush runs in the inter-batch gap (outside the timed window).
        for item in staged_for_batch(b):
            store.stage_model_outputs(*item)
        store.flush_staged()
        if log and b % 10 == 0:
            log(f"batch {b}: {lat[-1]*1e3:.1f} ms "
                f"hit {store.stats.hit_rate:.3f}")

    st = store.stats.as_dict()
    compute_ms = compute["s"] / max(n_batches, 1) * 1e3
    st.update(
        policy=policy,
        mean_batch_ms=float(np.mean(lat) * 1e3),
        p50_batch_ms=float(np.percentile(lat, 50) * 1e3),
        p95_batch_ms=float(np.percentile(lat, 95) * 1e3),
        p99_batch_ms=float(np.percentile(lat, 99) * 1e3),
        compute_ms=compute_ms,
        modeled_fetch_ms_per_batch=store.modeled_batch_ms(),
        # The paper's §VII-F decomposition: device compute (policy-
        # independent) + the slow-tier on-demand model.
        modeled_e2e_ms=compute_ms + store.modeled_batch_ms(),
    )
    # Synchronous serving: every on-demand fetch sits on the critical
    # path, so the stall is the whole modeled slow-tier cost.
    st["on_demand_stall_ms"] = round(store.stats.modeled_fetch_s * 1e3, 3)
    if multi_table:
        st["per_table_hit_rates"] = [
            round(h, 4) for h in store.per_table_hit_rates()]
    reg = MetricsRegistry()
    store.publish_metrics(reg)
    st["metrics"] = reg.snapshot()
    if collect_logits:
        st["logits"] = (np.stack(logits) if logits
                        else np.zeros((0, batch_queries), np.float32))
    return st


def _dense_forward(params, cfg, dense, pooled):
    """DLRM forward given already-pooled embeddings (B, T, D) -> (B,)
    logits in the compute dtype."""
    ct = torch_dtype(cfg.compute_dtype)
    bot = _mlp(params["bottom"], dense.to(ct))
    return interact_top(params, bot, pooled.to(ct))


# Flags whose subsystem is not ported yet, with the ROADMAP item that
# ports it.  Each raises NotImplementedError when set.
_NOT_PORTED = (
    ("shards", "--shards", "A10 (sharded + fault path)"),
    ("fault_plan", "--fault-plan", "A10 (sharded + fault path)"),
    ("replicate_hot", "--replicate-hot", "A10 (sharded + fault path)"),
    ("async_prefetch", "--async-prefetch", "A12 (pipelined runtime)"),
    ("overload", "--overload", "A12 (pipelined runtime)"),
    ("adapt", "--adapt", "A12 (pipelined runtime)"),
    ("workload", "--workload", "A6 (workloads)"),
)


def cli_outputs(args, trace: Trace, capacity: int, dev):
    """The recmg model outputs the CLI serves with, and the store policy:
    as ``src/repro/launch/serve.py:545-575``."""
    if args.policy == "lru":
        return None, "lru"
    if args.policy == "recmg-oracle":
        out = precompute_outputs(trace)
        return RecMGOutputs(out.chunk_starts, None, None), args.policy
    if args.model == "frequency":
        return frequency_outputs(trace, capacity), "recmg"
    if args.model == "voyager":
        # Prefetch-only baseline: LRU residency + Voyager's stream.
        return voyager_outputs(trace, capacity, epochs=args.train_epochs,
                               device=dev), "lru"
    model = LearnedRecMGModel.train_from_trace(
        trace, capacity, cli_learned_config(args.train_epochs), log=print,
        device=dev)
    return model.outputs_for(trace), "recmg"


def cli_learned_config(train_epochs: int) -> LearnedModelConfig:
    """The CLI-scale knobs of ``--model learned`` (the LearnedModelConfig
    defaults are tuned for the small scenario-matrix scale): the seed
    launcher's model size, epochs from --train-epochs, sparser windows and
    the wide deployment candidate pool."""
    return LearnedModelConfig(
        hidden=40, caching_epochs=train_epochs, prefetch_epochs=train_epochs,
        batch_size=256, lr=3e-3, train_stride=5, n_candidates=5000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the fast tier and the forward run: cuda "
                         "(default; raises when CUDA is absent) or cpu")
    ap.add_argument("--policy", default="recmg",
                    choices=["lru", "recmg", "recmg-oracle"])
    ap.add_argument("--model", default="learned",
                    choices=["learned", "frequency", "voyager"],
                    help="where the recmg model outputs come from: the "
                         "trained dual models (learned, trained on the "
                         "trace on --device), the deterministic frequency "
                         "heuristic, or the Voyager-class ML prefetcher "
                         "baseline (prefetch stream on an LRU store)")
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-queries", type=int, default=32)
    ap.add_argument("--capacity-frac", type=float, default=0.2)
    ap.add_argument("--accesses", type=int, default=200_000)
    ap.add_argument("--train-epochs", type=int, default=3)
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--row-format", default="int8", choices=("int8", "fp8"))
    ap.add_argument("--multi-table", action="store_true")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--placement", default="table",
                    choices=["table", "row", "hash", "freq"])
    ap.add_argument("--async-prefetch", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--scheduler", default="inline",
                    choices=["inline", "thread"])
    ap.add_argument("--overload", type=float, default=0.0)
    ap.add_argument("--priority-mix", default="")
    ap.add_argument("--queue-bound", type=int, default=0)
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--replicate-hot", type=int, default=0)
    ap.add_argument("--workload", default="")
    ap.add_argument("--adapt", action="store_true")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "run to this path (enables span tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="write the run's metrics-registry snapshot JSON "
                         "to this path")
    ap.add_argument("--flight-recorder", default="",
                    help="also write the flight-recorder ring — spans of "
                         "the last --trace-ring batches — to this path")
    ap.add_argument("--trace-ring", type=int, default=64,
                    help="flight-recorder ring size in batches")
    args = ap.parse_args(argv)
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet: ROADMAP {item}")

    dev = resolve_device(args.device)
    cfg = get_config("dlrm-recmg").reduced()
    params = init_dlrm(cfg, seed=0, device=dev)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=args.accesses, drift_every=10**9))
    capacity = int(args.capacity_frac * trace.unique_count())
    if args.quantize:
        # Hold the byte budget fixed: re-spend the fp32 budget implied by
        # --capacity-frac as quantized rows (D + 4 bytes each).
        fp32_bytes = capacity * fast_row_bytes(cfg.emb_dim, np.float32,
                                               False)
        capacity = fp32_bytes // fast_row_bytes(cfg.emb_dim, np.float32,
                                                True, args.row_format)
        print(f"quantize({args.row_format}): {fp32_bytes} fast-tier bytes "
              f"-> {capacity} resident rows")
    outputs, pol = cli_outputs(args, trace, capacity, dev)

    tracer = None
    if args.trace_out or args.flight_recorder:
        from repro_torch.obs.tracing import SpanTracer, install_tracer

        # Synchronous serving traces wall time.
        tracer = SpanTracer(ring_batches=args.trace_ring)
        install_tracer(tracer)
    try:
        res = serve_trace(cfg, params, trace, capacity, pol, outputs,
                          batch_queries=args.batch_queries,
                          multi_table=args.multi_table,
                          quantize=args.quantize,
                          row_format=(args.row_format if args.quantize
                                      else None),
                          log=print, device=dev)
    finally:
        if tracer is not None:
            install_tracer(None)

    if args.metrics_out:
        import json

        with open(args.metrics_out, "w") as f:
            json.dump(res["metrics"], f, indent=1, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_out}")
    if tracer is not None:
        from repro_torch.obs import reconcile, validate_chrome_trace

        trace_obj = tracer.chrome_trace()
        if args.trace_out:
            tracer.write(args.trace_out)
            print(f"trace ({len(trace_obj['traceEvents'])} events) -> "
                  f"{args.trace_out}")
        if args.flight_recorder:
            tracer.write(args.flight_recorder, flight_only=True)
            print(f"flight recorder -> {args.flight_recorder}")
        problems = validate_chrome_trace(trace_obj)
        problems += reconcile(metrics=res["metrics"], trace=trace_obj,
                              strict=False)
        if problems:
            print("RECONCILIATION PROBLEMS:")
            for p in problems:
                print(f"  {p}")
            raise SystemExit(1)
        print("trace/metrics reconciliation: OK")
    print({k: v for k, v in res.items() if k != "metrics"})
    return res


if __name__ == "__main__":
    main()
