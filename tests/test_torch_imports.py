"""repro_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {n}"


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core import caching_model as CM
    from repro_torch.core import prefetch_model as PM
    from repro_torch.core import voyager as VY
    from repro_torch.core.features import make_windows
    from repro_torch.core.model_runtime import (LearnedRecMGModel,
                                                voyager_outputs)
    from repro_torch.core.serving import MultiTableTieredStore
    from repro_torch.core.tiered import TieredEmbeddingStore
    from repro_torch.core.trace import TraceGenConfig, generate_trace
    from repro_torch.launch.serve import main, serve_trace
    from repro_torch.launch.serve_lm import main as serve_lm_main
    from repro_torch.launch.serve_lm import serve_lm_tiered
    from repro_torch.models.dlrm import init_dlrm
    from repro_torch.models.model_api import build
    from repro_torch.models.transformer import init_lm
    from repro_torch.workloads import (make_spec, replay_overload,
                                       replay_scenario, scenario)

    cfg = get_config("dlrm-recmg").reduced()
    lm = get_config("smollm-135m").reduced()
    trace = generate_trace(TraceGenConfig(n_tables=2, rows_per_table=50,
                                          n_accesses=500, seed=0))
    windows = make_windows(trace, in_len=15)
    return {
        "store": lambda: TieredEmbeddingStore(np.zeros((8, 4), np.float32),
                                              4),
        "quantized_store": lambda: TieredEmbeddingStore(
            np.zeros((8, 4), np.float32), 4, quantize=True),
        "multi_table_store": lambda: MultiTableTieredStore(
            [np.zeros((8, 4), np.float32)] * 2, capacity=4),
        "serve_trace": lambda: serve_trace(cfg, None, trace, 4, "lru", None),
        "init_dlrm": lambda: init_dlrm(cfg),
        "cli": lambda: main(["--policy", "lru", "--accesses", "500"]),
        "learned_model": lambda: LearnedRecMGModel.train_from_trace(
            trace, 4),
        "voyager_outputs": lambda: voyager_outputs(trace, 4),
        "cli_learned": lambda: main(["--accesses", "500"]),
        "train_caching_model": lambda: CM.train_caching_model(
            windows, CM.CachingModelConfig(n_tables=2, hidden=8), epochs=1),
        "train_prefetch_model": lambda: PM.train_prefetch_model(
            PM.make_prefetch_data(trace),
            PM.PrefetchModelConfig(n_tables=2, hidden=8), epochs=1),
        "train_voyager": lambda: VY.train_voyager(
            windows, VY.VoyagerConfig(n_vectors=trace.n_vectors), 2,
            epochs=1),
        "serve_lm_tiered": lambda: serve_lm_tiered(lm, steps=2),
        "serve_lm_cli": lambda: serve_lm_main(["--reduced", "--steps", "2"]),
        "lm_prefill": lambda: build(lm).prefill(
            None, {"tokens": np.zeros((1, 4), np.int64)}),
        "init_lm": lambda: init_lm(lm),
        "replay_scenario": lambda: replay_scenario(scenario("zipf_mid")),
        "replay_overload": lambda: replay_overload(make_spec(
            "sustained_overload", n_accesses=1000)),
    }


@pytest.mark.parametrize("entry", ["store", "quantized_store",
                                   "multi_table_store", "serve_trace",
                                   "init_dlrm", "cli", "learned_model",
                                   "voyager_outputs", "cli_learned",
                                   "train_caching_model",
                                   "train_prefetch_model", "train_voyager",
                                   "serve_lm_tiered", "serve_lm_cli",
                                   "lm_prefill", "init_lm",
                                   "replay_scenario", "replay_overload"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()
