"""The port's ranks for ``tests/test_torch_distributed.py``: four ``gloo``
processes on the CPU, started by ``torch.multiprocessing.spawn`` on a
``file://`` store (no TCP port, so parallel test workers cannot collide).
Imports no JAX: each rank reads the JAX parameters and the inputs from an
``.npz`` the test wrote and leaves its results in another."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import mesh as M
from repro_torch.distributed.fault_tolerance import ElasticMesh
from repro_torch.models import dlrm as D
from repro_torch.models.model_api import build

DTYPES = ("float32", "bfloat16")
CASES = ("in", "out")
MODEL_PARALLEL = (1, 2, 3, 4, 5)


def cfg_for(dtype):
    return dataclasses.replace(get_config("dlrm-recmg").reduced(),
                               param_dtype=dtype, compute_dtype=dtype)


def jax_tree(data, dtype):
    """The JAX parameter pytree of ``dtype`` from the test's ``.npz`` (bf16
    arrays stored as their uint16 bits)."""
    def arr(key):
        a = data[f"{dtype}/{key}"]
        if dtype == "bfloat16":
            return torch.from_numpy(a).view(torch.bfloat16)
        return torch.from_numpy(a)

    n = {k: int(data[f"{dtype}/n_{k}"]) for k in ("bottom", "top")}
    return {"emb": arr("emb"),
            **{k: {"w": [arr(f"{k}/w{i}") for i in range(n[k])],
                   "b": [arr(f"{k}/b{i}") for i in range(n[k])]}
               for k in ("bottom", "top")}}


def shard_tree(tree, rows):
    """``tree`` as the port's parameters on the CPU, ``rows`` of every
    table (``params_from_jax(rows=)`` without the NumPy round trip)."""
    lo, hi = rows
    return {"emb": tree["emb"][:, lo:hi].contiguous(),
            **{k: tree[k] for k in ("bottom", "top")}}


def rank_main(rank, world, store, inputs, out_dir):
    M.init_distributed("gloo", f"file://{store}", rank, world,
                       device="cpu", timeout=60)
    res = {}
    for mp in MODEL_PARALLEL:
        res[f"host_mesh/{mp}"] = np.array(
            list(M.make_host_mesh(mp).shape.values()))
        res[f"elastic_mesh/{mp}"] = np.array(
            list(ElasticMesh(mp).make().shape.values()))
    mesh = M.make_mesh(2, 2)
    res["coords"] = np.array([mesh.data_rank, mesh.model_rank])
    data = np.load(inputs)
    for dtype in DTYPES:
        cfg = cfg_for(dtype)
        rows = D.shard_rows(cfg.rows_per_table, mesh)
        params = shard_tree(jax_tree(data, dtype), rows)
        bundle = build(cfg, device="cpu",
                       run=RunConfig(dlrm_sharded_lookup=True))
        for case in CASES:
            dense = M.batch_shard(torch.from_numpy(data[f"dense/{case}"]),
                                  mesh)
            idx = M.batch_shard(torch.from_numpy(data[f"idx/{case}"]), mesh)
            with M.activation_sharding(mesh):
                logits = bundle.prefill(params, {"dense": dense,
                                                 "sparse": idx})
                pooled = D.embedding_lookup_rowsharded(
                    params["emb"], idx, mesh, rows=cfg.rows_per_table)
            res[f"{dtype}/{case}/logits"] = \
                M.gather_batch(logits, mesh).float().numpy()
            res[f"{dtype}/{case}/pooled"] = \
                M.gather_batch(pooled.float(), mesh).numpy()
    # A model axis that does not divide the tables' rows raises.
    one_by_four = M.make_mesh(1, 4)
    try:
        D.shard_rows(cfg.rows_per_table + 2, one_by_four)
        res["uneven_raises"] = np.array(False)
    except ValueError:
        res["uneven_raises"] = np.array(True)
    M.close_distributed()
    np.savez(f"{out_dir}/rank{rank}.npz", **res)
