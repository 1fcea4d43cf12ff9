"""The port's batch and cache layouts and its dry-run report against the
JAX package's, on the CPU.

``batch_pspecs`` and ``cache_pspecs`` equal JAX's leaf by leaf for every
arch and shape cell, on meshes (1, 1) to (16, 16) and the (2, 16, 16)
pod stand-in, under every variant and both ``shard_kv_seq`` (JAX takes a
stand-in mesh with ``axis_names`` and ``shape``, all its rules read; a
port cache spec is JAX's less the stacked layer dim).
``ModelBundle.cache_struct`` has JAX's names, shapes and dtypes.  The
dry-run report of every cell on the two production stand-ins
(``launch/dryrun.py``'s (16, 16) and (2, 16, 16)) equals what JAX's
``lower_cell`` writes without XLA: ``status`` and ``reason``,
``param_bytes_per_device`` (``_sizeof`` over ``param_pspecs``),
``n_params``, ``n_active_params``, ``microbatches``
(``auto_microbatches``), and ``model_flops``/``model_bytes`` by
``repro.launch.roofline`` (fed the port's argument bytes where JAX reads
XLA's).  ``repro.launch.dryrun`` is not imported here: it sets
``XLA_FLAGS`` for 512 devices at import.  The CLI runs without JAX and
writes one JSON a cell.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ALL_ARCHS, RunConfig as JRunConfig
from repro.configs import auto_microbatches as jax_auto_microbatches
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.configs import shapes_for as jax_shapes_for
from repro.launch import roofline as jax_roofline
from repro.models.model_api import build as jax_build
from repro.sharding import partition as jsp
from repro_torch.configs import get_config, shapes_for
from repro_torch.launch import dryrun
from repro_torch.models.model_api import build
from repro_torch.sharding import partition as SP

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 1), (2, 2), (1, 4), (4, 1), (3, 1), (1, 3), (16, 16),
          (2, 16, 16))


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return dict(zip(axes, shape))


def _jmesh(sizes):
    return SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _norm(spec) -> tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_bundle(arch):
    return jax_build(jax_get_config(arch))


def _id(m):
    return "x".join(map(str, m))


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh):
    sizes, jb = _mesh(mesh), _jax_bundle(arch)
    bundle = build(get_config(arch), device="meta")
    jm = _jmesh(sizes)
    for name, shape in jax_shapes_for(jb.cfg).items():
        bstruct = jb.batch_struct(shape)
        for variant in SP.VARIANTS:
            want = jsp.batch_pspecs(bstruct, jm, variant)
            got = SP.batch_pspecs({k: SimpleNamespace(shape=d) for k, (d, _)
                                   in bundle.batch_struct(shape).items()},
                                  sizes, variant)
            assert sorted(got) == sorted(want), (name, variant)
            for k in got:
                assert got[k] == _norm(want[k]), (name, variant, k)
        cstruct = jb.cache_struct(shape)
        if cstruct is None:
            assert bundle.cache_struct(shape) is None
            continue
        port = bundle.cache_struct(shape)
        for kv_seq in (True, False):
            want = jsp.cache_pspecs(cstruct, jm, kv_seq)
            got = SP.cache_pspecs(port, sizes, kv_seq)
            assert sorted(got) == sorted(want), (name, kv_seq)
            for k, spec in got.items():
                stacked = (None,) + spec if spec else ()
                assert _norm(stacked) == _norm(want[k]), (name, kv_seq, k)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_struct_matches_jax(arch):
    jb = _jax_bundle(arch)
    bundle = build(get_config(arch), device="meta")
    for name, shape in jax_shapes_for(jb.cfg).items():
        want = jb.cache_struct(shape)
        got = bundle.cache_struct(shape)
        if want is None:
            assert got is None
            continue
        assert sorted(got) == sorted(want), name
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert t.device.type == "meta"
            assert str(t.dtype)[6:] == str(want[k].dtype), (name, k)


@functools.lru_cache(maxsize=None)
def _jax_param_bytes(arch, mesh_name):
    sizes = dryrun.MESHES[mesh_name]
    jb = _jax_bundle(arch)
    struct = jb.param_struct()
    specs = jsp.param_pspecs(struct, _jmesh(sizes), "fsdp_tp", "all")
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(struct),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(x, P))):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        shards = 1
        for ent in spec:
            for ax in () if ent is None else (
                    (ent,) if isinstance(ent, str) else ent):
                shards *= sizes[ax]
        total += n * leaf.dtype.itemsize // shards
    return total


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dryrun_report_matches_jax(arch, mesh_name):
    from repro_torch.configs import RunConfig

    jb = _jax_bundle(arch)
    jcfg = jb.cfg
    sizes = dryrun.MESHES[mesh_name]
    n_data = int(np.prod([sizes[a] for a in ("pod", "data")
                          if a in sizes]))
    for name, shape in jax_shapes_for(jcfg).items():
        rep = dryrun.lower_cell(arch, name, mesh_name == "2x16x16",
                                RunConfig())
        ok, why = jax_shape_applicable(jcfg, shape)
        assert rep["status"] == ("ok" if ok else "skipped"), name
        assert (rep["arch"], rep["shape"], rep["mesh"], rep["kind"]) == (
            arch, name, mesh_name, shape.kind)
        if not ok:
            assert rep["reason"] == why
            continue
        assert rep["devices"] == int(np.prod(list(sizes.values())))
        assert rep["param_bytes_per_device"] == _jax_param_bytes(
            arch, mesh_name), name
        assert rep["n_params"] == jb.n_params()
        assert rep["n_active_params"] == jb.n_active_params()
        assert rep["microbatches"] == jax_auto_microbatches(
            jcfg, shape, n_data)
        jcell = {**rep, "memory_analysis": {
            "argument_size_in_bytes": rep["argument_bytes_per_device"]}}
        assert rep["model_flops"] == jax_roofline.model_flops(jcell), name
        assert rep["model_bytes"] == jax_roofline.model_bytes(jcell), name
    assert sorted(shapes_for(get_config(arch))) == sorted(
        jax_shapes_for(jcfg))


def test_dryrun_cli_writes_one_json_a_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--mesh", "single", "--out", str(tmp_path),
         "--tag", "t", "--sharding", "fsdp_seq", "--no-shard-kv-seq"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    files = sorted((tmp_path / "t").glob("*.json"))
    assert [f.name for f in files] == sorted(
        f"smollm-135m__{s}__16x16.json" for s in shapes_for(
            get_config("smollm-135m")))
    cells = {json.loads(f.read_text())["shape"]: json.loads(f.read_text())
             for f in files}
    assert cells["long_500k"]["status"] == "skipped"
    dec = cells["decode_32k"]
    assert dec["run_config"]["sharding"] == "fsdp_seq"
    assert dec["run_config"]["shard_kv_seq"] is False
    assert dec["cache_bytes_per_device"] > 0


def test_config_helpers_match_jax():
    from repro_torch import configs as PC

    assert PC.ALL_ARCHS == ALL_ARCHS
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name, shape in jax_shapes_for(jcfg).items():
            mine = PC.shapes_for(cfg)[name]
            assert (mine.kind, mine.seq_len, mine.global_batch) == (
                shape.kind, shape.seq_len, shape.global_batch)
            assert PC.shape_applicable(cfg, mine) == jax_shape_applicable(
                jcfg, shape)
            for n_data in (1, 3, 16, 32):
                assert PC.auto_microbatches(cfg, mine, n_data) == \
                    jax_auto_microbatches(jcfg, shape, n_data)
    assert PC.RunConfig().shard_kv_seq == JRunConfig().shard_kv_seq
