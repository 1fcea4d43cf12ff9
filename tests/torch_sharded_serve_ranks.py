"""The port's ranks for ``tests/test_torch_sharded_serve.py``: four
``gloo`` processes on the CPU, started by ``torch.multiprocessing.spawn``
on a ``file://`` store.  Imports no JAX: each rank reads JAX's initial
parameters and the batches from the ``.npz`` the test wrote and leaves its
results in ``rank<r>.npz``.

Every rank, over the world of four:
- for each case (``arch|sharding|data|model|shard_kv_seq|cap``), builds
  the reduced arch from JAX's parameters with ``build(..., mesh=)``, cuts
  its shards (``shard_model``) and serves the global batch: the prefill
  (capacity ``cap``) and three decode steps.  It keeps its logits rows,
  its part of every cache leaf after the prefill and after the last
  step, the positions and offsets its sequence-parallel attention
  took (``kv_stream_attention``'s q rows, offset and key count) and its
  rows of the batch;
- trains reduced qwen2.5-3b two steps under ``fsdp_seq`` and ``fsdp`` on
  (4, 1), whose layouts coincide (``train/bit_equal``: losses and every
  shard bit for bit), and under ``fsdp_seq`` on (2, 2) against the same
  steps on one rank (``train/...``): JAX's trainer's semantics, the batch
  over ``data`` and no sequence split (``train/kv_stream_calls``).
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.data.lm_data import LMDataConfig, batch_at
from repro_torch.distributed import mesh as M
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.sharding import partition as SP
from repro_torch.tree import leaves, named_leaves

TRAIN_ARCH = "qwen2.5-3b"


def case_cfg(arch):
    """The reduced arch; hymba's window cut to 6 (its ring shorter than
    the prompt), as ``tests/jax_sharded_serve_ref.py`` cuts it."""
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, window=6) if cfg.family == "hybrid" \
        else cfg


def whole_model(data, arch):
    """The reduced arch with JAX's initial parameters, whole."""
    cfg = case_cfg(arch)
    model = build(cfg, device="cpu").init(seed=0)
    with torch.no_grad():
        for name, p in named_leaves(model):
            p.copy_(torch.from_numpy(data[f"init/{arch}/{name}"]))
    return cfg, model


class SeqCalls:
    """Within the scope: ``(q rows, q_offset, key count)`` of every
    ``kv_stream_attention`` call."""

    def __enter__(self):
        self.calls, self._fn = [], L.kv_stream_attention

        def record(q, k, v, window=0, bk=512, q_offset=0, causal=True):
            self.calls.append((q.shape[1], q_offset, k.shape[1]))
            return self._fn(q, k, v, window, bk, q_offset, causal)

        L.kv_stream_attention = record
        return self

    def __exit__(self, *exc):
        L.kv_stream_attention = self._fn


def serve_case(data, case, res):
    arch, sharding, nd, nm, kv_seq, cap = case.split("|")
    mesh = M.make_mesh(int(nd), int(nm))
    cfg, model = whole_model(data, arch)
    run = RunConfig(sharding=sharding, shard_kv_seq=kv_seq == "1")
    bundle = build(cfg, device="cpu", run=run, mesh=mesh)
    model = T.shard_model(model, mesh, sharding)
    batch = {"tokens": data[f"{case}/tokens"]}
    if f"{case}/frontend" in data:
        batch["frontend"] = data[f"{case}/frontend"]
    with SeqCalls() as seq:
        logits, cache = bundle.prefill(model, batch, int(cap))
    res[f"{case}/seq_calls"] = np.array(seq.calls, np.int64).reshape(-1, 3)
    res[f"{case}/logits0"] = logits.numpy().copy()
    leaves = [k for k in cache if isinstance(cache[k], torch.Tensor)]
    for name in leaves:
        res[f"{case}/prefill/{name}"] = cache[name].float().numpy().copy()
    for i, tok in enumerate(data[f"{case}/steps"]):
        logits, cache = bundle.decode(model, tok, cache)
        res[f"{case}/logits{i + 1}"] = logits.numpy().copy()
    for name in leaves:
        res[f"{case}/decode/{name}"] = cache[name].float().numpy().copy()
    b, s = batch["tokens"].shape
    res[f"{case}/rows"] = SP.shard_of(
        torch.arange(b), SP.batch_spec((b, s), mesh, sharding)[:1],
        mesh).numpy()


def train(data, sharding, mesh, steps=2):
    """``(losses, {leaf: shard}, model)`` of two steps of two microbatches
    of reduced qwen2.5-3b from JAX's parameters."""
    cfg, model = whole_model(data, TRAIN_ARCH)
    bundle = build(cfg, device="cpu", run=RunConfig(sharding=sharding),
                   mesh=mesh)
    if mesh is not None:
        model = T.shard_model(model, mesh, sharding)
    opt = init_opt(OptConfig(lr=1e-3, total_steps=steps), leaves(model))
    step = make_train_step(bundle, 2, mesh)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    losses = [step(model, opt, batch_at(dcfg, s))["loss"]
              for s in range(steps)]
    return (losses, {n: p.detach().clone() for n, p in named_leaves(model)},
            model)


def train_fsdp_seq(data, res):
    mesh = M.make_mesh(4, 1)
    (l0, p0, _), (l1, p1, _) = (train(data, s, mesh)
                                for s in ("fsdp_seq", "fsdp"))
    res["train/bit_equal"] = np.array(
        all(torch.equal(a, b) for a, b in zip(l0, l1))
        and all(torch.equal(p0[n], p1[n]) for n in p0))
    mesh = M.make_mesh(2, 2)
    with SeqCalls() as seq:
        losses, shards, model = train(data, "fsdp_seq", mesh)
    one, whole, _ = train(data, "fsdp_tp", None)
    res["train/kv_stream_calls"] = np.array(len(seq.calls))
    res["train/loss"] = np.array([[float(a) for a in losses],
                                  [float(a) for a in one]])
    err = 0.0
    for name, p in named_leaves(model):
        pl = M.placement(p)
        want = SP.shard_of(whole[name], () if pl is None else pl.spec, mesh)
        err = max(err, float((shards[name] - want).abs().max())
                  / max(1.0, float(want.abs().max())))
    res["train/param_err"] = np.array(err)


def rank_main(rank, world, work):
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    work = Path(work)
    data = np.load(work / "inputs.npz")
    res = {}
    M.init_distributed("gloo", f"file://{work}/store", rank, world,
                       device="cpu", timeout=120)
    for case in data["cases"]:
        serve_case(data, str(case), res)
    train_fsdp_seq(data, res)
    M.close_distributed()
    np.savez(work / f"rank{rank}.npz", **res)
