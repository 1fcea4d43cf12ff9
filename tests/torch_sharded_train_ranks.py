"""The port's ranks for ``tests/test_torch_sharded_train.py``: four
``gloo`` processes on the CPU, started by ``torch.multiprocessing.spawn``
on a ``file://`` store.  Imports no JAX: each rank reads JAX's initial
parameters from the ``.npz`` the test wrote and leaves its results in
``rank<r>.npz``.

Every rank, over the world of four:
- for each case (``arch|sharding|data|model``; DLRM's add ``|sharded`` or
  ``|dense``, the lookup; ``FIT_CASES`` the batch, the sequence and
  ``moe_local_dispatch``, :func:`case_opts`), builds the reduced arch
  from JAX's parameters, cuts its shards (``shard_model``; DLRM's
  tables by ``place_tables`` under ``emb_rows="all"``) and trains two
  steps of two microbatches
  under ``remat="full"`` inside ``activation_sharding(mesh, sharding)``
  (as JAX's side does: under ``fsdp_seq`` the scope splits the
  sequence): each step's loss and grad norm, and its shard of every
  parameter and moment after them; with them the names of the leaves
  gathered over ``model`` (a view that keeps the model part does not
  count), the shapes the step all-reduced and the sequence lengths the
  loss received;
- trains the first arch with ``sharding="dp"`` and with a bundle built
  without the mesh (whole parameters, the mesh's data all-reduce): every
  loss and parameter, bit for bit (``dp/...``);
- trains the first arch under ``fsdp_tp`` on (2, 2) for three steps,
  checkpointing after two (``ckpt/...``), and resumes that checkpoint on a
  (1, 4) mesh: the third step's loss and its shards against the unbroken
  run's; and DLRM with its tables under ``emb_rows="all"`` the same way
  (``dlrm_ckpt/...``);
- trains DLRM through ``build(..., mesh=)`` under ``emb_rows="model"``
  and as a bundle without the mesh over its ``shard_params``: every loss,
  grad norm and parameter, bit for bit (``dlrm_model/...``);
- trains reduced falcon-mamba-7b, hymba-1.5b and whisper-large-v3 (whose
  mamba blocks, attention, cross-attention and MLPs compute tensor
  parallel) under ``fsdp_tp`` on (2, 2) and, in the same process, on one
  rank: the losses and its shard of every parameter against the one
  rank's (``tp_family/...``).
Then rank 0 alone, outside any process group, resumes both checkpoints on
one rank.
"""
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import RunConfig, get_config
from repro_torch.data.lm_data import LMDataConfig, batch_at
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import gather_leaf
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import _restore
from repro_torch.models import dlrm as D
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.sharding.partition import shard_of, spec_axes
from repro_torch.tree import leaves, named_leaves

CKPT_STEPS = 3
TP_FAMILIES = ("falcon-mamba-7b", "hymba-1.5b", "whisper-large-v3")
DLRM = "dlrm-recmg"
# Shapes an axis does not divide (``|B=``: the global batch of two
# microbatches, ``|S=``: the sequence, ``|local``: moe_local_dispatch).
FIT_CASES = ("qwen2.5-3b|fsdp_tp|2|2|B=2", "qwen2.5-3b|fsdp|2|2|B=4",
             "qwen2.5-3b|fsdp_seq|2|2|S=15",
             "granite-moe-1b-a400m|fsdp_seq|2|2|local",
             "granite-moe-1b-a400m|fsdp_seq|2|2|local|B=2",
             "granite-moe-1b-a400m|fsdp_seq|2|2|B=2",
             "granite-moe-1b-a400m|fsdp_seq|2|2|local|B=2|S=15",
             "granite-moe-1b-a400m|fsdp_tp|2|2|local|B=2",
             # bf16 (``|bf16``): JAX's parameters cast.
             "qwen2.5-3b|fsdp_tp|2|2|B=2|bf16",
             "granite-moe-1b-a400m|fsdp_seq|2|2|local|bf16")


def case_opts(case):
    """A case's options after ``arch|sharding|data|model``: ``{"B": n,
    "S": n}`` where given, and its flags (``local``, DLRM's lookup)."""
    out = {}
    for opt in case.split("|")[4:]:
        key, _, val = opt.partition("=")
        out[key] = int(val) if val else True
    return out


def whole_model(data, arch, dtype="float32"):
    """The reduced arch in ``dtype`` with JAX's initial parameters (cast
    where the arch holds a leaf in it), whole."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype,
                              compute_dtype=dtype)
    model = build(cfg, device="cpu").init(seed=0)
    with torch.no_grad():
        for name, p in named_leaves(model):
            p.copy_(torch.from_numpy(data[f"init/{arch}/{name}"]))
    return cfg, model


def batch_fn(data, arch, cfg, seq=None, batch=None):
    """``batch(s)``: DLRM's step-s batch of the inputs, else ``batch_at``'s
    (whisper's with the inputs' frames)."""
    if cfg.family == "dlrm":
        return lambda s: {k: data[f"dlrm/{s}/{k}"]
                          for k in ("dense", "sparse", "label")}
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=seq or int(data["seq"]),
                        global_batch=batch or int(data["batch"]))

    def batch(s):
        b = batch_at(dcfg, s)
        if cfg.enc_dec:
            b["frontend"] = data[f"frames/{arch}/{s}"]
        return b

    return batch


def trainer(data, arch, sharding, mesh, steps, build_mesh=True, seq=None,
            batch=None, dtype="float32", **run_kw):
    """``(model, opt, step_fn, batch(s))`` for ``arch`` on ``mesh``."""
    cfg, model = whole_model(data, arch, dtype)
    run = RunConfig(remat="full", sharding=sharding, **run_kw)
    bundle = build(cfg, device="cpu", run=run,
                   mesh=mesh if build_mesh else None)
    if build_mesh and mesh is not None:
        model = (D.place_tables(model, mesh, sharding, run.emb_rows)
                 if cfg.family == "dlrm"
                 else T.shard_model(model, mesh, sharding))
    opt = init_opt(OptConfig(lr=float(data["lr"]), total_steps=steps),
                   leaves(model))
    step = make_train_step(bundle, int(data["microbatches"]), mesh)
    return model, opt, step, batch_fn(data, arch, cfg, seq, batch)


def put(res, prefix, named):
    for name, t in named:
        res[f"{prefix}/{name}"] = t.detach().float().numpy().copy()


class Watch:
    """Within the scope: the names of ``model``'s leaves that a view
    gathers over the ``model`` axis (``gather_leaf`` without
    ``keep_model`` on a leaf placed there), and the shapes of the
    tensors the sum all-reduces."""

    def __init__(self, model):
        self.names = {id(p): n for n, p in named_leaves(model)}

    def __enter__(self):
        self.model_gathered, self.reduced = set(), []
        self._gather, self._reduce = C.gather_leaf, C.all_reduce_

        def gather(p, keep_model=False):
            pl = M.placement(p)
            if pl is not None and not keep_model \
                    and "model" in spec_axes(pl.spec):
                self.model_gathered.add(self.names.get(id(p), "?"))
            return self._gather(p, keep_model)

        def reduce(x, group):
            self.reduced.append(tuple(x.shape))
            return self._reduce(x, group)

        C.gather_leaf, C.all_reduce_ = gather, reduce
        return self

    def __exit__(self, *exc):
        C.gather_leaf, C.all_reduce_ = self._gather, self._reduce


class SeqRows:
    """Within the scope: the sequence lengths of the token batches the
    LM losses received (a split's rank part under ``fsdp_seq``)."""

    def __enter__(self):
        self.lengths, self._lm, self._ed = set(), T.lm_loss, ED.encdec_loss

        def lm(model, cfg, run, tokens, *a, **kw):
            self.lengths.add(tokens.shape[1])
            return self._lm(model, cfg, run, tokens, *a, **kw)

        def ed(model, cfg, run, tokens, *a, **kw):
            self.lengths.add(tokens.shape[1])
            return self._ed(model, cfg, run, tokens, *a, **kw)

        T.lm_loss, ED.encdec_loss = lm, ed
        return self

    def __exit__(self, *exc):
        T.lm_loss, ED.encdec_loss = self._lm, self._ed


def train_case(data, case, res):
    arch, sharding, nd, nm = case.split("|")[:4]
    opts = case_opts(case)
    mesh = M.make_mesh(int(nd), int(nm))
    steps = int(data["steps"])
    kw = ({"dlrm_sharded_lookup": "sharded" in opts} if arch == DLRM
          else {"moe_local_dispatch": "local" in opts})
    model, opt, step, batch = trainer(data, arch, sharding, mesh, steps,
                                      seq=opts.get("S"),
                                      batch=opts.get("B"),
                                      dtype=("bfloat16" if "bf16" in opts
                                             else "float32"), **kw)
    # JAX's side trains inside activation_sharding(mesh, sharding): under
    # fsdp_seq that scope splits the sequence.
    with Watch(model) as watch, M.activation_sharding(mesh, sharding), \
            SeqRows() as rows:
        ms = [step(model, opt, batch(s)) for s in range(steps)]
    res[f"{case}/seq_rows"] = np.array(sorted(rows.lengths))
    res[f"{case}/loss"] = np.array([float(m["loss"]) for m in ms])
    res[f"{case}/grad_norm"] = np.array([float(m["grad_norm"]) for m in ms])
    names = [n for n, _ in named_leaves(model)]
    put(res, f"{case}/param", named_leaves(model))
    state = opt.state_dict()
    put(res, f"{case}/m", zip(names, state["m"]))
    put(res, f"{case}/v", zip(names, state["v"]))
    res[f"{case}/specs"] = np.array(repr({n: p.placement.spec
                                          for n, p in named_leaves(model)
                                          if M.placement(p) is not None}))
    res[f"{case}/model_gathered"] = np.array(repr(sorted(
        watch.model_gathered)))
    res[f"{case}/reduced"] = np.array(repr(watch.reduced))


def dp_bits(data, arch, res):
    """``sharding="dp"`` against the step of a bundle built without the
    mesh: the same losses and parameters, bit for bit."""
    mesh = M.make_mesh(2, 2)
    steps = int(data["steps"])
    out = []
    for build_mesh in (True, False):
        model, opt, step, batch = trainer(data, arch, "dp", mesh, steps,
                                          build_mesh)
        losses = [step(model, opt, batch(s))["loss"] for s in range(steps)]
        out.append((losses, [p.detach().clone() for p in
                             model.parameters()], model))
    (l0, p0, m0), (l1, p1, _) = out
    res["dp/untagged"] = np.array(all(M.placement(p) is None
                                      for p in m0.parameters()))
    res["dp/bit_equal"] = np.array(
        all(torch.equal(a, b) for a, b in zip(l0, l1))
        and all(torch.equal(a, b) for a, b in zip(p0, p1)))


def dlrm_model_bits(data, res):
    """DLRM through ``build(..., mesh=)`` with ``emb_rows="model"`` against
    a bundle built without the mesh over the rank's ``shard_params`` (the
    row-sharded training's own set-up): the same losses, grad norms (the
    second step's above 1: it clips) and parameters, bit for bit."""
    mesh = M.make_mesh(2, 2)
    steps = int(data["steps"])
    out = []
    for placed in (True, False):
        model, opt, step, batch = trainer(
            data, DLRM, "fsdp_tp", mesh, steps, build_mesh=placed,
            dlrm_sharded_lookup=True, emb_rows="model")
        if not placed:
            model = D.shard_params(model, mesh)
            opt = init_opt(OptConfig(lr=float(data["lr"]),
                                     total_steps=steps), leaves(model))
        ms = [step(model, opt, batch(s)) for s in range(steps)]
        out.append(([m["loss"] for m in ms] + [m["grad_norm"] for m in ms],
                    [p.detach().clone() for p in leaves(model)], model))
    (m0, p0, model), (m1, p1, _) = out
    res["dlrm_model/spec"] = np.array(repr(model["emb"].placement.spec))
    res["dlrm_model/grad_norm"] = np.array([float(n) for n in m0[steps:]])
    res["dlrm_model/bit_equal"] = np.array(
        all(torch.equal(a, b) for a, b in zip(m0, m1))
        and all(torch.equal(a, b) for a, b in zip(p0, p1)))


def checkpoint_across_meshes(data, arch, work, res, key="ckpt", **kw):
    """Three steps on (2, 2), checkpointed after two; the third step
    resumed on (1, 4).  Returns the unbroken run's whole parameters."""
    mesh = M.make_mesh(2, 2)
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", mesh,
                                      CKPT_STEPS, **kw)
    for s in range(CKPT_STEPS - 1):
        step(model, opt, batch(s))
    ckpt.save(str(work / key), CKPT_STEPS - 1,
              {"params": model, "opt": opt.state_dict()},
              write=mesh.rank == 0)
    res[f"{key}/loss"] = np.array(float(step(model, opt, batch(
        CKPT_STEPS - 1))["loss"]))
    with torch.no_grad():
        whole = {n: gather_leaf(p) for n, p in named_leaves(model)}
    torch.distributed.barrier()  # the checkpoint is written

    mesh = M.make_mesh(1, 4)
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", mesh,
                                      CKPT_STEPS, **kw)
    start = _restore(str(work / key), model, opt)
    res[f"{key}/start_14"] = np.array(start)
    res[f"{key}/loss_14"] = np.array(float(step(model, opt, batch(
        start))["loss"]))
    err = 0.0
    for n, p in named_leaves(model):
        pl = M.placement(p)
        want = whole[n] if pl is None else shard_of(whole[n], pl.spec, mesh)
        err = max(err, float((p.detach() - want).abs().max())
                  / max(1.0, float(want.abs().max())))
    res[f"{key}/param_err_14"] = np.array(err)
    return whole


def one_rank_resume(data, arch, work, whole, res, key="ckpt", **kw):
    model, opt, step, batch = trainer(data, arch, "fsdp_tp", None,
                                      CKPT_STEPS, **kw)
    start = _restore(str(work / key), model, opt)
    res[f"{key}/loss_11"] = np.array(float(step(model, opt, batch(
        start))["loss"]))
    res[f"{key}/param_err_11"] = np.array(max(
        float((p.detach() - whole[n]).abs().max())
        / max(1.0, float(whole[n].abs().max()))
        for n, p in named_leaves(model)))


def tp_families(data, res):
    """Each arch of ``TP_FAMILIES`` trained two steps on (2, 2) and on one
    rank from seed 0 (whisper's audio frames a seeded draw)."""
    mesh = M.make_mesh(2, 2)
    steps, mb = int(data["steps"]), int(data["microbatches"])
    for arch in TP_FAMILIES:
        cfg = get_config(arch).reduced()
        dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=int(data["seq"]),
                            global_batch=int(data["batch"]))

        def batch(s):
            b = batch_at(dcfg, s)
            if cfg.enc_dec:
                b["frontend"] = np.random.default_rng(s).normal(size=(
                    dcfg.global_batch, cfg.enc_len, cfg.d_model)).astype(
                        np.float32)
            return b

        out = []
        for m in (None, mesh):
            bundle = build(cfg, device="cpu", run=RunConfig(remat="full"),
                           mesh=m)
            model = bundle.init(seed=0)
            opt = init_opt(OptConfig(lr=float(data["lr"]), total_steps=steps),
                           list(model.parameters()))
            step = make_train_step(bundle, mb, m)
            out.append(([float(step(model, opt, batch(s))["loss"])
                         for s in range(steps)], model))
        (l0, whole), (l1, model) = out
        want = dict(named_leaves(whole))
        res[f"tp_family/{arch}/loss"] = np.array([l0, l1])
        res[f"tp_family/{arch}/sharded_leaves"] = np.array(sum(
            bool(p.placement.spec) for p in model.parameters()))
        res[f"tp_family/{arch}/param_err"] = np.array(max(
            float((p.detach() - shard_of(want[n].detach(), p.placement.spec,
                                         mesh)).abs().max())
            / max(1.0, float(want[n].abs().max()))
            for n, p in named_leaves(model)))


def rank_main(rank, world, work):
    torch.set_num_threads(1)  # four ranks share the test worker's cores
    work = Path(work)
    data = np.load(work / "inputs.npz")
    res = {}
    M.init_distributed("gloo", f"file://{work}/store", rank, world,
                       device="cpu", timeout=120)
    for case in list(data["cases"]) + list(data["dlrm_cases"]):
        train_case(data, str(case), res)
    first = str(data["cases"][0]).split("|")[0]
    dp_bits(data, first, res)
    dlrm_model_bits(data, res)
    tp_families(data, res)
    whole = checkpoint_across_meshes(data, first, work, res)
    dlrm_whole = checkpoint_across_meshes(data, DLRM, work, res,
                                          "dlrm_ckpt")
    M.close_distributed()
    if rank == 0:
        one_rank_resume(data, first, work, whole, res)
        one_rank_resume(data, DLRM, work, dlrm_whole, res, "dlrm_ckpt")
    np.savez(work / f"rank{rank}.npz", **res)
