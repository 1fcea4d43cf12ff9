"""The port's serve_trace against the JAX package's, on the golden fixture.

The fixture is that of ``tests/test_golden_trace.py``: the reduced
``dlrm-recmg`` with 4 tables of 1024 rows, multi_hot 2, emb_dim 16, an
8000-access trace and 8 queries per batch.  The counters are deterministic
(host table, trace and dense inputs are numpy draws), so they must equal
``tests/golden/serve_lru.json`` under ``lru`` and a live JAX run under
``recmg`` with the frequency model, exactly.
"""
import dataclasses
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.recmg import frequency_outputs
from repro_torch.core.trace import TraceGenConfig, generate_trace
from repro_torch.launch.serve import main, serve_trace
from repro_torch.models.dlrm import init_dlrm

GOLDEN = Path(__file__).parent / "golden" / "serve_lru.json"
SERVE_KEYS = ("policy", "batches", "lookups", "hits", "hit_rate",
              "prefetch_hits", "on_demand_rows", "evictions",
              "on_demand_stall_ms", "modeled_fetch_ms_per_batch")


@lru_cache(maxsize=1)
def _fixture():
    cfg = dataclasses.replace(get_config("dlrm-recmg").reduced(),
                              n_tables=4, rows_per_table=1024, multi_hot=2,
                              emb_dim=16)
    trace = generate_trace(TraceGenConfig(
        n_tables=cfg.n_tables, rows_per_table=cfg.rows_per_table,
        n_accesses=8000, seed=0, drift_every=10**9))
    return cfg, init_dlrm(cfg, seed=0, device="cpu"), trace


def test_serve_lru_reproduces_golden():
    cfg, params, trace = _fixture()
    cap = int(0.15 * trace.unique_count())
    res = serve_trace(cfg, params, trace, cap, "lru", None, batch_queries=8,
                      device="cpu", collect_logits=True)
    assert {k: res[k] for k in SERVE_KEYS} == json.loads(GOLDEN.read_text())
    assert res["hits"] + res["misses"] == res["lookups"]
    assert res["logits"].shape == (res["batches"], 8)
    assert np.isfinite(res["logits"]).all()


def test_serve_recmg_frequency_matches_live_jax_run():
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core.recmg import frequency_outputs as jax_frequency_outputs
    from repro.launch.serve import serve_trace as jax_serve_trace
    from repro.models.dlrm import init_dlrm as jax_init_dlrm

    cfg, params, trace = _fixture()
    cap = int(0.15 * trace.unique_count())
    got = serve_trace(cfg, params, trace, cap, "recmg",
                      frequency_outputs(trace, cap), batch_queries=8,
                      device="cpu")
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               n_tables=4, rows_per_table=1024, multi_hot=2,
                               emb_dim=16)
    jparams = jax_init_dlrm(jax.random.PRNGKey(0), jcfg)
    want = jax_serve_trace(jcfg, jparams, trace, cap, "recmg",
                           jax_frequency_outputs(trace, cap), batch_queries=8)
    keys = SERVE_KEYS + ("misses",)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["prefetch_hits"] > 0
    assert got["metrics"]["counters"]["store.fast.hits"] == \
        want["metrics"]["counters"]["store.fast.hits"]


@pytest.mark.parametrize("cap", [1, 300, 5000])
def test_frequency_outputs_match_jax(cap):
    from repro.core.recmg import frequency_outputs as jax_frequency_outputs

    trace = _fixture()[2]
    want = jax_frequency_outputs(trace, cap)
    got = frequency_outputs(trace, cap)
    for f in ("chunk_starts", "caching_bits", "prefetch_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_cli_smoke_traced(tmp_path, capsys):
    trace_out, metrics_out = tmp_path / "t.json", tmp_path / "m.json"
    res = main(["--device", "cpu", "--policy", "lru", "--accesses", "3000",
                "--batch-queries", "4", "--trace-out", str(trace_out),
                "--metrics-out", str(metrics_out)])
    out = capsys.readouterr().out
    assert "trace/metrics reconciliation: OK" in out
    assert res["batches"] == 3000 // (4 * 8 * 4)
    assert json.loads(metrics_out.read_text())["counters"][
        "store.lookups"] == res["lookups"]
    assert json.loads(trace_out.read_text())["traceEvents"]


def test_cli_recmg_frequency():
    res = main(["--device", "cpu", "--policy", "recmg", "--model",
                "frequency", "--accesses", "3000", "--batch-queries", "4"])
    assert res["policy"] == "recmg" and res["lookups"] > 0


@pytest.mark.parametrize("argv", [
    ["--quantize"],
    ["--quantize", "--row-format", "fp8"],
], ids=["int8", "fp8"])
def test_cli_quantize_spends_the_same_bytes_as_jax(argv, capsys):
    """``--quantize`` re-spends the fp32 byte budget of --capacity-frac as
    quantized rows and prints the same line as the JAX CLI; the counters
    of the two runs are equal."""
    from repro.launch.serve import main as jax_main

    common = ["--policy", "lru", "--accesses", "3000", "--batch-queries",
              "4", *argv]
    res = main(["--device", "cpu", *common])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("quantize(")]
    want_res = jax_main(common)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("quantize(")]
    assert got == want and len(got) == 1
    fmt = argv[-1] if len(argv) > 1 else "int8"
    assert got[0].startswith(f"quantize({fmt}): ")
    keys = ("batches", "lookups", "hits", "misses", "on_demand_rows",
            "evictions")
    assert {k: res[k] for k in keys} == {k: want_res[k] for k in keys}


def test_cli_multi_table():
    res = main(["--device", "cpu", "--policy", "recmg", "--model",
                "frequency", "--multi-table", "--accesses", "3000",
                "--batch-queries", "4"])
    cfg = get_config("dlrm-recmg").reduced()
    assert len(res["per_table_hit_rates"]) == cfg.n_tables
    assert res["hits"] + res["misses"] == res["lookups"] > 0
    assert res["metrics"]["gauges"]["tables.n_tables"] == cfg.n_tables


@pytest.mark.parametrize("argv,item", [
    (["--shards", "2"], "A10"),
    (["--fault-plan", "kill:1@mid"], "A10"),
    (["--replicate-hot", "8"], "A10"),
])
def test_cli_flags_not_ported_raise(argv, item):
    """The sharded path's flags (ROADMAP ``item``), which raised
    ``NotImplementedError`` before that item was ported, now serve on the
    CPU and give the JAX CLI's counters, ``shard`` telemetry and ``ft.*``
    fates (``--fault-plan`` and ``--replicate-hot`` on 2 shards)."""
    from repro.launch.serve import main as jax_main

    shards = [] if "--shards" in argv else ["--shards", "2"]
    common = ["--policy", "recmg", "--model", "frequency", "--accesses",
              "3000", "--batch-queries", "4", *shards, *argv]
    got = main(["--device", "cpu", *common])
    want = jax_main(common)
    keys = CLI_COUNTERS + ("on_demand_stall_ms", "shard",
                           "shard_load_imbalance")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert ("ft" in got) == ("--fault-plan" in argv) == ("ft" in want)
    if "--fault-plan" in argv:
        assert got["ft"] == want["ft"] and got["ft"]["kills"] == 1
    assert item == "A10"


CLI_COUNTERS = ("batches", "lookups", "hits", "misses", "prefetch_hits",
                "on_demand_rows", "evictions", "modeled_fetch_ms_per_batch")
# Runtime counters that depend only on the operations, not on the modeled
# timeline (which, without --overload, overlaps the measured forward).
RT_COUNTERS = ("batches", "requests", "pf_submitted", "pf_deduped",
               "pf_cancelled_resident", "pf_issued", "pf_populate_calls",
               "pf_channel_scheduled", "rank_cancelled_evicted",
               "demand_fetch_ms")


@pytest.mark.parametrize("argv,extra", [
    (["--async-prefetch", "--pipeline-depth", "3"],
     ("pf_accuracy", "pf_coverage")),
    (["--overload", "8"], ("on_demand_stall_ms", "runtime", "admission",
                           "goodput_rps", "offered_rps")),
    (["--adapt", "--workload", "diurnal", "--accesses", "12000"],
     ("on_demand_stall_ms", "drift")),
    (["--workload", "zipf_hot"], ("on_demand_stall_ms",)),
], ids=["async-prefetch", "overload", "adapt", "workload"])
def test_cli_runtime_flags_match_jax(argv, extra):
    """``--async-prefetch``, ``--overload``, ``--adapt`` and ``--workload``
    run with ``--device cpu`` and give the JAX CLI's counters.  The inline
    scheduler replays the same operations; the modeled stall is compared
    where the modeled compute is pinned (``--overload``) or absent (the
    synchronous paths), since otherwise it overlaps the measured forward."""
    from repro.launch.serve import main as jax_main

    common = ["--policy", "recmg", "--model", "frequency", "--accesses",
              "3000", "--batch-queries", "4", *argv]
    got = main(["--device", "cpu", *common])
    want = jax_main(common)
    keys = CLI_COUNTERS + extra
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["hits"] + got["misses"] == got["lookups"] > 0
    if "--overload" in argv:
        adm = got["admission"]
        assert adm["admitted"] == adm["served"] + adm["shed"] + \
            adm["degraded"]
        assert adm["degraded"] > 0 and adm["degraded_rows_stale"] > 0
        assert got["metrics"]["counters"]["adm.admitted"] == adm["admitted"]
    if "--adapt" in argv:
        assert got["drift"]["refreshes"] >= 1
    if "--async-prefetch" in argv:
        assert {k: got["runtime"][k] for k in RT_COUNTERS} == \
            {k: want["runtime"][k] for k in RT_COUNTERS}
        assert got["on_demand_stall_ms"] < \
            got["runtime"]["demand_fetch_ms"]


@pytest.mark.parametrize("argv", [
    ["--async-prefetch", "--fault-plan", "kill:1@mid,recover:1@75%",
     "--replicate-hot", "16"],
    ["--overload", "4", "--placement", "freq"],
    ["--quantize", "--placement", "hash", "--fault-plan",
     "flaky:1x0.5@25%..75%", "--fault-seed", "3"],
], ids=["async-prefetch-faults", "overload-freq", "int8-flaky"])
def test_cli_sharded_runtime_flags_match_jax(argv):
    """The sharded store under ``--async-prefetch`` (with a kill and a
    recovery), under ``--overload`` and with quantized rows on a flaky
    shard: the JAX CLI's counters, shard telemetry and fates."""
    from repro.launch.serve import main as jax_main

    common = ["--policy", "recmg", "--model", "frequency", "--accesses",
              "3000", "--batch-queries", "4", "--shards", "2", *argv]
    got = main(["--device", "cpu", *common])
    want = jax_main(common)
    keys = CLI_COUNTERS + ("shard_load_imbalance",)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    for k in ("per_shard_lookups", "per_shard_hit_rate",
              "per_shard_evictions", "modeled_fetch_ms_critical",
              "per_shard_pf_issued", "ft"):
        assert got["shard"].get(k) == want["shard"].get(k), k
    assert got.get("ft") == want.get("ft")
    if "--overload" in argv:
        assert got["admission"] == want["admission"]
    if "--async-prefetch" in argv:
        assert {k: got["runtime"][k] for k in RT_COUNTERS} == \
            {k: want["runtime"][k] for k in RT_COUNTERS}


def test_cli_sharded_flag_errors():
    with pytest.raises(ValueError, match="requires --shards"):
        main(["--device", "cpu", "--policy", "lru", "--accesses", "3000",
              "--fault-plan", "kill:1@mid"])
    with pytest.raises(ValueError, match="at most one"):
        main(["--device", "cpu", "--policy", "lru", "--accesses", "3000",
              "--shards", "2", "--multi-table"])


def test_cli_thread_scheduler_traced(tmp_path, capsys):
    """The thread scheduler through the CLI: the worker's apply timing is
    scheduler-dependent, but the run's trace and metrics reconcile and the
    accounting identities hold."""
    trace_out = tmp_path / "t.json"
    res = main(["--device", "cpu", "--policy", "recmg", "--model",
                "frequency", "--accesses", "3000", "--batch-queries", "4",
                "--async-prefetch", "--scheduler", "thread", "--trace-out",
                str(trace_out)])
    assert "trace/metrics reconciliation: OK" in capsys.readouterr().out
    rt = res["runtime"]
    assert res["hits"] + res["misses"] == res["lookups"] > 0
    assert rt["batches"] == res["batches"]
    assert rt["stall_ms"] <= rt["demand_fetch_ms"]
    assert res["metrics"]["counters"]["rt.pf.issued"] == rt["pf_issued"] > 0


@pytest.mark.parametrize("argv,policy", [
    (["--model", "learned"], "recmg"),
    (["--model", "voyager"], "lru"),
    (["--policy", "recmg-oracle"], "recmg-oracle"),
], ids=["learned", "voyager", "recmg-oracle"])
def test_cli_learned_paths_run(argv, policy):
    """The CLI's default learned path, the Voyager arm and the oracle grid
    run on the CPU and serve with the JAX CLI's store policy."""
    res = main(["--device", "cpu", "--policy", "recmg", "--train-epochs",
                "1", "--accesses", "3000", "--batch-queries", "4", *argv])
    assert res["policy"] == policy
    assert res["hits"] + res["misses"] == res["lookups"] > 0
    if policy == "recmg-oracle":
        assert res["prefetch_hits"] == 0


@lru_cache(maxsize=1)
def _jax_learned():
    """A JAX LearnedRecMGModel trained on the golden fixture's trace, and
    the port's LearnedRecMGModel carrying its parameters."""
    from repro.core.model_runtime import LearnedModelConfig as JCfg
    from repro.core.model_runtime import LearnedRecMGModel as JModel
    import jax

    from repro_torch.core.caching_model import CachingModel
    from repro_torch.core.lstm import params_from_jax
    from repro_torch.core.model_runtime import (LearnedModelConfig,
                                                LearnedRecMGModel)
    from repro_torch.core.prefetch_model import PrefetchModel

    cfg, _, trace = _fixture()
    cap = int(0.15 * trace.unique_count())
    kw = dict(hidden=16, caching_epochs=1, prefetch_epochs=1,
              train_stride=8)
    jm = JModel.train_from_trace(trace, cap, JCfg(**kw))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tm = LearnedRecMGModel(
        LearnedModelConfig(**kw), jm.mcfg, jm.pcfg,
        params_from_jax(CachingModel(jm.mcfg), tree(jm.cparams)),
        params_from_jax(PrefetchModel(jm.pcfg), tree(jm.pparams)),
        jm.cand_ids, cap, trace)
    return cap, jm, tm


def test_serve_learned_outputs_match_jax_counters():
    """The JAX model's outputs served by both packages give the same
    counters exactly; the port's outputs from the carried parameters make
    the same decisions wherever the margin exceeds 1e-4."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import serve_trace as jax_serve_trace
    from repro.models.dlrm import init_dlrm as jax_init_dlrm

    cfg, params, trace = _fixture()
    cap, jm, tm = _jax_learned()
    want_out = jm.outputs_for(trace)
    got = serve_trace(cfg, params, trace, cap, "recmg", want_out,
                      batch_queries=8, device="cpu")
    jcfg = dataclasses.replace(jax_get_config("dlrm-recmg").reduced(),
                               n_tables=4, rows_per_table=1024, multi_hot=2,
                               emb_dim=16)
    want = jax_serve_trace(jcfg, jax_init_dlrm(jax.random.PRNGKey(0), jcfg),
                           trace, cap, "recmg", want_out, batch_queries=8)
    keys = SERVE_KEYS + ("misses",)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["prefetch_hits"] > 0

    data, starts = tm.serving_windows(trace)
    np.testing.assert_array_equal(starts, want_out.chunk_starts)
    logits = tm.predict_logits(data)
    ids, gaps = tm.decode_points(tm.predict_points(data),
                                 return_margins=True)
    sure_bits = np.abs(logits) >= 1e-4
    sure_ids = gaps >= 1e-4
    assert sure_bits.mean() > 0.99 and sure_ids.mean() > 0.99
    np.testing.assert_array_equal((logits > 0)[sure_bits],
                                  want_out.caching_bits[sure_bits])
    np.testing.assert_array_equal(ids[sure_ids],
                                  want_out.prefetch_ids[sure_ids])
