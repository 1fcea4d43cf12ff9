"""The port's partition rules against the JAX package's, at full size.

For every config of the registry (the LMs, whisper and dlrm-recmg), the
port's ``param_specs`` on its model built on the ``meta`` device equals
JAX's ``param_pspecs`` on ``bundle.param_struct()``, leaf by leaf (the
port's per-layer leaf holds JAX's spec less the stacked dim), on meshes
(1, 1) to (16, 16), under every variant and both ``emb_rows``; JAX takes
a stand-in mesh with ``axis_names`` and ``shape``, which is all
``param_pspecs`` reads.  ``shard_bytes`` equals the per-device bytes that
``launch/dryrun.py::_sizeof`` (:46-62) computes from JAX's specs.  Then a
rank's ``shard_of`` against ``shard_shape``, and the rule's per-rank
parameter counts at (2, 2) for qwen2.5-3b and qwen3-14b; where the
fused ``in_proj``'s columns go (``in_proj_blocks``); and a DLRM rank's
rows of the tables under both ``emb_rows`` against the JAX device's at
the same mesh position (four CPU devices in a subprocess).
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.model_api import build as jax_build
from repro.sharding.partition import param_pspecs
from repro_torch.configs import get_config
from repro_torch.models.model_api import build
from repro_torch.sharding import partition as SP

MESHES = ((1, 1), (2, 2), (1, 4), (4, 1), (3, 1), (1, 3), (16, 16))


def _mesh(shape):
    return SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": shape[0], "model": shape[1]})


@functools.lru_cache(maxsize=None)
def _jax_struct(arch):
    return jax_build(jax_get_config(arch)).param_struct()


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return build(get_config(arch), device="meta").param_struct()


def _jax_named(struct, specs):
    """``({port leaf name: JAX's spec of it}, [(shape, itemsize, spec) of
    each JAX leaf])``: a stacked leaf's spec less its leading dim, once a
    layer."""
    out, sizes = {}, []
    flat = jax.tree_util.tree_flatten_with_path(struct)[0]
    flat_s = jax.tree_util.tree_leaves(specs,
                                       is_leaf=lambda x: isinstance(x, P))
    for (path, leaf), spec in zip(flat, flat_s):
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        entries = tuple(spec)
        if names[0] in SP.STACKED_KEYS:
            assert not entries or entries[0] is None, (names, spec)
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = entries[1:]
        else:
            out[".".join(names)] = entries
        sizes.append((tuple(leaf.shape), leaf.dtype.itemsize, spec))
    return out, sizes


def _jax_sizeof(sizes, mesh) -> int:
    """``launch/dryrun.py::_sizeof`` (:46-62) over (shape, itemsize, spec)
    triples (importing dryrun would give this process 512 devices)."""
    total = 0
    for shape, itemsize, spec in sizes:
        n = int(np.prod(shape)) if shape else 1
        shards = 1
        for ent in spec:
            if ent is None:
                continue
            for ax in (ent,) if isinstance(ent, str) else ent:
                shards *= mesh.shape[ax]
        total += n * itemsize // shards
    return total


def test_every_arch_is_covered():
    from repro_torch.configs import _ARCHS

    assert sorted(ALL_ARCHS) == sorted(_ARCHS)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch, mesh):
    struct, model = _jax_struct(arch), _port_model(arch)
    jmesh = _mesh(mesh)
    for sharding in SP.VARIANTS:
        for emb_rows in SP.EMB_ROWS:
            jspecs = param_pspecs(struct, jmesh, sharding, emb_rows)
            want, sizes = _jax_named(struct, jspecs)
            got = SP.param_specs(model, mesh, sharding, emb_rows)
            assert sorted(got) == sorted(want), (sharding, emb_rows)
            for name, spec in got.items():
                assert spec == want[name], (sharding, emb_rows, name)
            assert SP.shard_bytes(model, got, mesh) == _jax_sizeof(
                sizes, jmesh), (sharding, emb_rows)


@pytest.mark.parametrize("arch,want", [("qwen2.5-3b", 0.849e9),
                                       ("qwen3-14b", 3.692e9)])
def test_per_rank_parameters_at_2x2(arch, want):
    """A quarter of every sharded leaf: 0.849 B and 3.692 B parameters a
    rank, from 3.397 B and 14.77 B."""
    model = _port_model(arch)
    specs = SP.param_specs(model, (2, 2))
    per_rank = SP.shard_bytes(model, specs, (2, 2), itemsize=1)
    whole = SP.shard_bytes(model, SP.param_specs(model, (2, 2), "dp"),
                           (2, 2), itemsize=1)
    assert abs(per_rank - want) < 0.0005e9, per_rank
    assert 0.24 < per_rank / whole < 0.26


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
def test_shard_of_tiles_the_leaf(mesh):
    """The ranks' parts of a leaf are disjoint, cover it, and have
    ``shard_shape``."""
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    world = mesh[0] * mesh[1]
    for spec in (("data", "model"), ("model", "data"),
                 (("data", "model"),), (None, ("data", "model")), ()):
        try:
            shape = SP.shard_shape(full.shape, spec, mesh)
        except ValueError:
            continue
        seen = torch.zeros_like(full)
        for r in range(world):
            part = SP.shard_of(full, spec, mesh, rank=r)
            assert tuple(part.shape) == shape
            seen.view(-1)[part.reshape(-1).long()] += 1
        copies = world // (full.numel() // int(np.prod(shape)))
        assert torch.equal(seen, torch.full_like(full, copies)), spec


def test_fit_spec_drops_axes_progressively():
    mesh = (2, 3)
    assert SP.fit_spec((4, 6), [("data", "model"), "model"], mesh) == (
        "data", "model")
    assert SP.fit_spec((12, 5), [("data", "model"), "model"], mesh) == (
        ("data", "model"),)
    assert SP.fit_spec((3, 5), ["data", None], mesh) == ()


def test_variants_and_fsdp_seq():
    from repro_torch.configs import RunConfig

    assert RunConfig().sharding == "fsdp_tp"
    run = RunConfig(sharding="fsdp_seq")
    assert run.sharding == "fsdp_seq" and run.shard_kv_seq
    assert not RunConfig(shard_kv_seq=False).shard_kv_seq
    with pytest.raises(ValueError, match="sharding"):
        RunConfig(sharding="zero")


def test_emb_rows_is_jax_option():
    from repro_torch.configs import RunConfig

    assert RunConfig().emb_rows == "all"
    assert RunConfig(emb_rows="model").emb_rows == "model"
    with pytest.raises(ValueError, match="emb_rows"):
        RunConfig(emb_rows="data")


@pytest.mark.parametrize("model", [1, 2, 4])
def test_in_proj_blocks_send_each_channel_to_its_rank(model):
    """JAX lays the fused ``in_proj`` (D, 2 Di) over ``model`` by columns as
    one block; ``in_proj_blocks`` sends each column of each rank's shard
    to the rank whose channels it holds: rank m then holds columns ``[m c,
    (m + 1) c)`` (``xi``) and ``Di + [m c, (m + 1) c)`` (``z``), c = Di /
    model, the split JAX's ``xz[..., :Di]`` / ``xz[..., Di:]`` makes."""
    di, c = 24, 24 // model
    cols = torch.arange(2 * di).reshape(1, -1)
    got = {(m, part): [] for m in range(model) for part in ("xi", "z")}
    for r in range(model):
        shard = SP.shard_of(cols, (None, "model"), (1, model), rank=r)
        blocks = SP.in_proj_blocks(di, model, r)
        assert sum(hi - lo for _, _, lo, hi in blocks) == shard.shape[1]
        for dest, part, lo, hi in blocks:
            got[(dest, part)] += shard[0, lo:hi].tolist()
    for m in range(model):
        assert got[(m, "xi")] == list(range(m * c, (m + 1) * c))
        assert got[(m, "z")] == list(range(di + m * c, di + (m + 1) * c))
    if model == 2:  # rank 0 holds every xi channel, rank 1 every z one
        assert SP.in_proj_blocks(di, 2, 0) == ((0, "xi", 0, 12),
                                              (1, "xi", 12, 24))
    with pytest.raises(ValueError, match="Di"):
        SP.in_proj_blocks(di + 1, 2, 0)


_JAX_ROWS = """
import json, jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.models.model_api import build
from repro.sharding.partition import param_pspecs
cfg = get_config("dlrm-recmg").reduced()
struct = build(cfg).param_struct()
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for emb_rows in ("all", "model"):
    spec = param_pspecs(struct, mesh, "fsdp_tp", emb_rows)["emb"]
    idx = NamedSharding(mesh, spec).devices_indices_map(struct["emb"].shape)
    where = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
    out[emb_rows] = {where[d.id]: [s[1].start or 0, s[1].stop or
                                   cfg.rows_per_table]
                     for d, s in idx.items()}
print(json.dumps(out))
"""


def test_dlrm_rank_rows_match_jax_on_four_devices():
    """A DLRM rank's rows of every table under ``emb_rows`` "all" (part d
    * model + m of both axes) and "model" (part m), on (2, 2), against the
    rows of the JAX device at its mesh position under ``param_pspecs``'s
    sharding of the tables (four CPU devices in a subprocess)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.distributed import mesh as M
    from repro_torch.models import dlrm as D

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(
        root / "src"), "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    want = json.loads(subprocess.run(
        [sys.executable, "-c", _JAX_ROWS], env=env, check=True,
        capture_output=True, text=True).stdout)
    cfg = get_config("dlrm-recmg").reduced()
    shape = (cfg.n_tables, cfg.rows_per_table, cfg.emb_dim)
    for emb_rows in ("all", "model"):
        for r in range(4):
            mesh = M.Mesh(2, 2, r)
            spec, rows = D._placed(shape, mesh, "fsdp_tp", emb_rows)
            assert list(rows) == want[emb_rows][str(r)], (emb_rows, r)
            params = D.init_placed(cfg, 0, "cpu", mesh, emb_rows=emb_rows)
            assert params["emb"].placement.spec == spec
            assert params["emb"].shape[1] == rows[1] - rows[0]
        if emb_rows == "model":
            assert D.shard_rows(cfg.rows_per_table, mesh) == rows
