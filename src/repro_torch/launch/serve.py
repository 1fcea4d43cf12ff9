"""DLRM serving launcher on tiered memory, in PyTorch on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy lru

Ported from ``src/repro/launch/serve.py``: the synchronous path and the
pipelined runtime (``--async-prefetch [--scheduler thread]``, the
admission path ``--overload X``), drift adaptation (``--adapt``) and the
workload scenarios (``--workload NAME``), through one store or the
per-table facade (``--multi-table``), with fp32 or quantized
(``--quantize [--row-format fp8]``) fast-tier rows.  Pipeline per
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
the JAX launcher's flags and defaults; the sharded path's flags
(``--shards``, ``--fault-plan``, ``--replicate-hot``) are not ported yet
and raise ``NotImplementedError`` naming ROADMAP A10.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.model_runtime import (LearnedController,
                                            LearnedModelConfig,
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
from repro_torch.runtime import (AdaptiveController, AdmissionConfig,
                                 DriftConfig, PipelinedRuntime,
                                 RuntimeConfig, VirtualClock)
from repro_torch.workloads import make_trace, parse_workload


def serve_trace(cfg, params, trace: Trace, capacity: int, policy: str,
                outputs: Optional[RecMGOutputs], batch_queries: int = 64,
                fetch_us_per_row: float = 10.0, multi_table: bool = False,
                async_prefetch: bool = False, pipeline_depth: int = 2,
                scheduler: str = "inline", interarrival_us: float = 0.0,
                compute_us: Optional[float] = None, adapt: bool = False,
                adapt_cfg=None, model=None, overload: float = 0.0,
                priority_mix=None, queue_bound: int = 0,
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

    ``async_prefetch=True`` serves through the pipelined runtime
    (:mod:`repro_torch.runtime`): requests go through the micro-batcher,
    staged model outputs are applied by the prefetch engine (``scheduler``
    ``"inline"``, deterministic, or ``"thread"``, a worker thread on the
    store's device and stream), and batch *k*'s slow-tier fetch overlaps
    batch *k-1*'s dense forward on the modeled timeline (``pipeline_depth``
    batches in flight).  With the inline scheduler the store sees the same
    operations as the synchronous path (identical counters); only the
    on-demand fetch *stall* accounting changes.  The result gains
    ``pf_accuracy``, ``pf_coverage`` and ``runtime``.

    ``adapt=True`` attaches the drift-adaptive controller
    (:class:`~repro_torch.runtime.drift.AdaptiveController`, or with the
    live learned ``model`` the
    :class:`~repro_torch.core.model_runtime.LearnedController`, which
    fine-tunes the model on the device at every refresh and swaps in its
    recomputed outputs) on either path; the result gains ``drift``.

    ``overload > 0`` (requires ``async_prefetch``) serves through the
    SLO-aware admission path: open-loop arrivals at ``overload`` times the
    modeled compute capacity, priorities drawn from ``priority_mix``, a
    queue bounded at ``queue_bound`` (default 4 batches), EDF batches,
    degraded answers past deadline (read on the device by the store's
    gather kernel) and prefetch backpressure.  A batch that closes below
    ``batch_queries`` is zero-padded on the device before the forward.  The
    result gains ``admission``, ``goodput_rps`` and ``offered_rps``.

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

    controller = None
    if adapt:
        if adapt_cfg is None:
            adapt_cfg = DriftConfig(window=max(1024, 4 * per_batch),
                                    hot_k=min(capacity, 256))
        if model is not None:
            controller = LearnedController(store, capacity, model, oref,
                                           trace, adapt_cfg)
        else:
            controller = AdaptiveController(store, capacity, adapt_cfg)

    def staged_for_batch(b):
        """Model outputs to stage after batch ``b``: caching priorities for
        every chunk the batch covered, but prefetches only from the most
        recent one — the paper issues ONE prefetch set per inference batch
        (Fig. 6); flooding every chunk's PO would churn the buffer.  Reads
        through ``oref`` so an online output refresh (LearnedController)
        takes effect at the next batch; the chunk grid is identical, so
        the chunk pointer stays valid."""
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
        the measured compute seconds.  Partial batches (an EDF pop under
        admission control can close a batch below ``batch_queries``) are
        zero-padded on the device to the full shape, as the JAX launcher
        pads them for its one jitted shape."""
        if emb.shape[0] < per_batch:
            emb = torch.cat([emb, emb.new_zeros(
                (per_batch - emb.shape[0], emb.shape[1]))])
        emb = emb.reshape(batch_queries, T, P, cfg.emb_dim).sum(dim=2)
        dense = torch.from_numpy(
            rng.normal(size=(batch_queries, cfg.dense_features))
            .astype(np.float32)).to(dev)
        t1 = time.perf_counter()
        out = _dense_forward(params, cfg, dense, emb)
        synchronize(dev)
        c = time.perf_counter() - t1
        compute["s"] += c
        return out, c

    # Warm the dense forward off the measured path: the first call pays
    # the CUDA library and allocator set-up.
    _dense_forward(params, cfg,
                   torch.zeros((batch_queries, cfg.dense_features),
                               device=dev),
                   torch.zeros((batch_queries, T, cfg.emb_dim), device=dev))
    synchronize(dev)

    rt = None
    adm_cfg = None
    if overload and not async_prefetch:
        raise ValueError("--overload requires --async-prefetch (the "
                         "admission path lives in the pipelined runtime)")
    if async_prefetch:
        if overload:
            # Offered load as a multiple of modeled compute capacity:
            # one batch per compute_us -> interarrival pins the rate.
            if compute_us is None:
                compute_us = 500.0
            interarrival_us = compute_us / (batch_queries * float(overload))
            adm_cfg = AdmissionConfig(
                queue_bound=int(queue_bound) if queue_bound
                else 4 * batch_queries,
                class_deadline_us=(4 * compute_us, 16 * compute_us,
                                   64 * compute_us))

        # ``compute_us`` pins the modeled device time per batch (so the
        # overlap window uses one cost model for both fetch and compute);
        # None overlaps against the measured wall-clock forward instead.
        # When a tracer with a virtual clock is installed, the runtime
        # shares it so the trace timeline and the modeled pipeline
        # timeline are one and the same.
        _tr = get_tracer()
        rt_clock = _tr.clock if (_tr.enabled
                                 and hasattr(_tr.clock, "advance_to")) \
            else None
        rt = PipelinedRuntime(store, RuntimeConfig(
            max_batch=batch_queries, pipeline_depth=pipeline_depth,
            interarrival_us=interarrival_us, scheduler=scheduler,
            fetch_us_per_row=fetch_us_per_row, compute_us=compute_us,
            admission=adm_cfg),
            clock=rt_clock,
            batch_hook=controller.on_batch if controller else None)

        def step(b, emb):
            out, c = forward_batch(emb)
            if collect_logits:
                logits.append(out.float().cpu().numpy())
            if log and b % 10 == 0:
                log(f"batch {b}: hit {store.stats.hit_rate:.3f} "
                    f"stall {rt.telemetry.stall_ms:.1f} ms")
            return c, staged_for_batch(b)

        qp = T * P  # ids per query = one request
        n_queries = n_batches * batch_queries
        if adm_cfg is not None:
            mix = np.asarray(priority_mix if priority_mix is not None
                             else (0.2, 0.3, 0.5), np.float64)
            if mix.size != adm_cfg.n_classes or mix.min() < 0 \
                    or mix.sum() <= 0:
                raise ValueError(f"priority_mix needs {adm_cfg.n_classes} "
                                 f"non-negative weights, got "
                                 f"{priority_mix!r}")
            pri = np.random.default_rng(2).choice(
                adm_cfg.n_classes, size=n_queries, p=mix / mix.sum())
            stream = ((gid[i * qp: (i + 1) * qp], int(pri[i]))
                      for i in range(n_queries))
        else:
            stream = (gid[i * qp: (i + 1) * qp]
                      for i in range(n_queries))
        rt.run(stream, step)
        lat = rt.wall_batch_s
    else:
        lat = []
        _tr = get_tracer()
        for b in range(n_batches):
            if _tr.enabled:
                _tr.set_batch(b)
            ids = gid[b * per_batch: (b + 1) * per_batch]
            pre_hits = store.stats.hits
            t0 = time.perf_counter()
            emb = store.lookup(ids)  # (per_batch, D)
            out, _ = forward_batch(emb)
            lat.append(time.perf_counter() - t0)
            if collect_logits:
                logits.append(out.float().cpu().numpy())
            # ``stage_model_outputs`` double-buffers: the outputs land at
            # the next batch boundary without blocking an in-flight
            # lookup; the flush runs in the inter-batch gap (outside the
            # timed window).
            for item in staged_for_batch(b):
                store.stage_model_outputs(*item)
            if controller is not None:
                # Adaptation items stage after the model's: the fresh
                # re-ranks must win over stale ones at the next drain.
                for item in controller.on_batch(
                        ids, store.stats.hits - pre_hits, b):
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
    if rt is not None:
        tel = rt.telemetry
        st["on_demand_stall_ms"] = round(tel.stall_ms, 3)
        st["pf_accuracy"] = round(
            store.stats.prefetch_hits / max(tel.pf_issued, 1), 4)
        st["pf_coverage"] = round(
            store.stats.prefetch_hits
            / max(store.stats.prefetch_hits + store.stats.on_demand_rows, 1),
            4)
        st["runtime"] = rt.results()
        if rt.admission_stats is not None:
            adm = rt.admission_stats
            modeled_s = max(rt.clock.now() * 1e-6, 1e-12)
            st["admission"] = adm.as_dict(adm_cfg)
            st["goodput_rps"] = round(adm.total_served / modeled_s, 3)
            st["offered_rps"] = round(1e6 / interarrival_us, 3)
    else:
        # Synchronous serving: every on-demand fetch sits on the critical
        # path, so the stall is the whole modeled slow-tier cost.
        st["on_demand_stall_ms"] = round(store.stats.modeled_fetch_s * 1e3,
                                         3)
    if controller is not None:
        st["drift"] = controller.as_dict()
    if multi_table:
        st["per_table_hit_rates"] = [
            round(h, 4) for h in store.per_table_hit_rates()]
    # One registry for every telemetry producer of the run (store, runtime
    # and admission, drift controller), so the reconciliation checker and
    # ``--metrics-out`` see a single flat counter space.
    reg = MetricsRegistry()
    store.publish_metrics(reg)
    if rt is not None:
        rt.publish(reg)
    if controller is not None:
        controller.publish(reg)
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
)


def cli_outputs(args, trace: Trace, capacity: int, dev):
    """The recmg model outputs the CLI serves with, the store policy and
    the live learned model (None unless ``--model learned``): as
    ``src/repro/launch/serve.py:543-575``."""
    if args.policy == "lru":
        return None, "lru", None
    if args.policy == "recmg-oracle":
        out = precompute_outputs(trace)
        return RecMGOutputs(out.chunk_starts, None, None), args.policy, None
    if args.model == "frequency":
        return frequency_outputs(trace, capacity), "recmg", None
    if args.model == "voyager":
        # Prefetch-only baseline: LRU residency + Voyager's stream.
        return voyager_outputs(trace, capacity, epochs=args.train_epochs,
                               device=dev), "lru", None
    model = LearnedRecMGModel.train_from_trace(
        trace, capacity, cli_learned_config(args.train_epochs), log=print,
        device=dev)
    return model.outputs_for(trace), "recmg", model


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
    ap.add_argument("--async-prefetch", action="store_true",
                    help="serve through the pipelined runtime: "
                         "micro-batcher, prefetch engine, fetch/compute "
                         "overlap")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="how many batches the host may run ahead of the "
                         "device (2 = double buffering; 1 = synchronous)")
    ap.add_argument("--scheduler", default="inline",
                    choices=["inline", "thread"],
                    help="prefetch-engine scheduler: inline is "
                         "deterministic; thread applies on a worker thread "
                         "on the store's device and stream")
    ap.add_argument("--overload", type=float, default=0.0,
                    help="serve open-loop at this multiple of modeled "
                         "compute capacity through the SLO-aware admission "
                         "path; implies --async-prefetch")
    ap.add_argument("--priority-mix", default="",
                    help="comma-separated traffic weights per priority "
                         "class, most-important first (default 0.2,0.3,0.5)")
    ap.add_argument("--queue-bound", type=int, default=0,
                    help="admission-queue bound in requests (default: 4 "
                         "batches)")
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--replicate-hot", type=int, default=0)
    ap.add_argument("--workload", default="",
                    help="serve a named workload scenario instead of the "
                         "default calibrated trace: a catalog name "
                         "(zipf_hot, diurnal, flash_crowd, multi_tenant, "
                         "churn, ...) or 'regime:key=val,...'")
    ap.add_argument("--adapt", action="store_true",
                    help="drift-adaptive serving: windowed hit-rate + "
                         "hot-set-Jaccard drift detector, online refresh "
                         "(and, with --model learned, fine-tune) on "
                         "trigger")
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

    if args.overload:
        args.async_prefetch = True

    dev = resolve_device(args.device)
    cfg = get_config("dlrm-recmg").reduced()
    params = init_dlrm(cfg, seed=0, device=dev)
    if args.workload:
        spec = parse_workload(args.workload)
        if spec.regime != "replay":  # replay: the file's geometry wins
            spec = spec.with_(n_tables=cfg.n_tables,
                              rows_per_table=cfg.rows_per_table,
                              n_accesses=args.accesses)
        trace = make_trace(spec)
    else:
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
    outputs, pol, model = cli_outputs(args, trace, capacity, dev)

    tracer = None
    if args.trace_out or args.flight_recorder:
        from repro_torch.obs.tracing import SpanTracer, install_tracer

        # Pipelined serving runs on the modeled (virtual) timeline, so
        # the trace does too; synchronous serving traces wall time.
        clock = VirtualClock() if args.async_prefetch else None
        tracer = SpanTracer(clock=clock, ring_batches=args.trace_ring)
        install_tracer(tracer)
    try:
        res = serve_trace(cfg, params, trace, capacity, pol, outputs,
                          batch_queries=args.batch_queries,
                          multi_table=args.multi_table,
                          async_prefetch=args.async_prefetch,
                          pipeline_depth=args.pipeline_depth,
                          scheduler=args.scheduler, adapt=args.adapt,
                          model=model, overload=args.overload,
                          priority_mix=tuple(
                              float(w) for w in
                              args.priority_mix.split(","))
                          if args.priority_mix else None,
                          queue_bound=args.queue_bound,
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
