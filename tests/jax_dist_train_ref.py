"""The JAX package's side of ``tests/test_torch_distributed_train.py``: run
as a script in a process of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.

    python tests/jax_dist_train_ref.py INPUTS.npz OUT.npz

Reads the test's inputs and writes, under keys the test reads:
- ``dlrm/...``: reduced dlrm-recmg (fp32) trained by ``make_train_step``
  with ``RunConfig(dlrm_sharded_lookup=True)`` on a (2, 2) mesh, two
  microbatches, two steps: each step's loss, its gradients (the mean of
  the microbatches' ``jax.grad`` under the same mesh scope) and the
  parameters after it;
- ``cmp/...``: ``compress_tree`` and ``psum_int8`` under ``shard_map``
  over four ``data`` devices, fed each device's gradients and errors;
- ``int8/...``: reduced smollm-135m trained two steps as the launcher's
  ``--grad-compression int8_ef`` path does (``make_compressed_dp_grads``
  and ``apply_updates`` under ``jax.jit`` on a (4, 1) mesh);
- ``plain/...``: reduced granite-moe-1b-a400m trained by a loop of
  ``make_train_step`` over ``batch_at`` on one device (JAX's launcher
  fails on its own mesh there: ROADMAP C).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

from repro.configs import RunConfig, get_config
from repro.data.lm_data import LMDataConfig, batch_at
from repro.distributed.compression import (compress_tree, init_error,
                                           make_compressed_dp_grads,
                                           psum_int8)
from repro.launch.steps import make_train_step
from repro.models import dlrm as D
from repro.models import model_api as MA
from repro.models import transformer as T
from repro.optim.adamw import OptConfig, apply_updates, init_opt
from repro.sharding import partition as sp


STACKED = ("blocks", "enc_blocks", "dec_blocks")


def named(tree):
    """{port leaf name: array}: key paths joined by dots, the stacked
    layer axis of an LM's ``blocks`` (whisper's ``enc_blocks`` and
    ``dec_blocks``) unrolled."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        leaf = np.asarray(leaf, np.float32)
        if names[0] in STACKED:
            for i in range(leaf.shape[0]):
                out[".".join([names[0], str(i)] + names[1:])] = leaf[i]
        else:
            out[".".join(names)] = leaf
    return out


def make_mesh(shape, axes=("data", "model")):
    """A mesh of Auto axes, which GSPMD partitions (``jax.make_mesh``'s
    default Explicit axes refuse the train step's sharding constraints)."""
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def put(out, prefix, tree):
    for k, v in named(tree).items():
        out[f"{prefix}/{k}"] = v


def dlrm(data, out):
    cfg = get_config("dlrm-recmg").reduced()
    bundle = MA.build(cfg, RunConfig(remat="none", dlrm_sharded_lookup=True))
    opt_cfg = OptConfig(lr=float(data["lr"]))
    params = D.init_dlrm(jax.random.PRNGKey(0), cfg)
    opt = init_opt(opt_cfg, params)
    mesh = make_mesh((2, 2))
    mb = int(data["dlrm/microbatches"])
    with sp.activation_sharding(mesh):
        step = jax.jit(make_train_step(bundle, opt_cfg, mb, mesh))
        grad = jax.jit(jax.grad(bundle.loss))
        for s in range(int(data["dlrm/steps"])):
            batch = {k: jnp.asarray(data[f"dlrm/{s}/{k}"])
                     for k in ("dense", "sparse", "label")}
            n = batch["label"].shape[0] // mb
            gs = [grad(params, {k: v[i * n:(i + 1) * n]
                                for k, v in batch.items()})
                  for i in range(mb)]
            put(out, f"dlrm/{s}/grad",
                jax.tree_util.tree_map(lambda *g: sum(g) / mb, *gs))
            params, opt, m = step(params, opt, batch)
            out[f"dlrm/{s}/loss"] = np.asarray(m["loss"], np.float32)
            put(out, f"dlrm/{s}/param", params)


def compression(data, out):
    mesh = make_mesh((4,), ("data",))
    n_leaves = int(data["cmp/n"])
    g = [jnp.asarray(data[f"cmp/g{i}"]) for i in range(n_leaves)]
    e = [jnp.asarray(data[f"cmp/e{i}"]) for i in range(n_leaves)]

    def local(g, e):
        g, e = [x[0] for x in g], [x[0] for x in e]
        q, s, new_e = compress_tree(g, e)
        summed = psum_int8(q, s, "data", 4)
        return ([x[None] for x in q], [x[None] for x in s],
                [x[None] for x in new_e], [x[None] for x in summed])

    spec = [P("data")] * n_leaves
    q, s, new_e, summed = shard_map(
        local, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, spec, spec, spec), check_rep=False)(g, e)
    for i in range(n_leaves):
        out[f"cmp/q{i}"] = np.asarray(q[i])
        out[f"cmp/s{i}"] = np.asarray(s[i])
        out[f"cmp/e{i}"] = np.asarray(new_e[i])
        out[f"cmp/sum{i}"] = np.asarray(summed[i])


def lm_data(data, cfg, prefix):
    return LMDataConfig(vocab=cfg.vocab, seq_len=int(data[f"{prefix}/seq"]),
                        global_batch=int(data[f"{prefix}/batch"]))


def int8_ef(data, out):
    """The JAX launcher's int8_ef loop (``train.py:85-100``)."""
    cfg = get_config("smollm-135m").reduced()
    steps = int(data["int8/steps"])
    bundle = MA.build(cfg, RunConfig(remat="none"))
    opt_cfg = OptConfig(lr=float(data["lr"]), total_steps=steps)
    params = T.init_lm(jax.random.PRNGKey(0), cfg)
    opt = init_opt(opt_cfg, params)
    mesh = make_mesh((4, 1))
    dcfg = lm_data(data, cfg, "int8")
    with mesh, sp.activation_sharding(mesh):
        grads_fn = make_compressed_dp_grads(bundle.loss, mesh)
        err = init_error(params)

        def step_fn(params, opt, err, batch):
            loss, grads, err = grads_fn(params, err, batch)
            params, opt, m = apply_updates(opt_cfg, params, opt, grads)
            m["loss"] = loss
            return params, opt, err, m

        jstep = jax.jit(step_fn)
        losses = []
        for s in range(steps):
            batch = {k: jnp.asarray(v) for k, v in batch_at(dcfg, s).items()}
            params, opt, err, m = jstep(params, opt, err, batch)
            losses.append(float(m["loss"]))
    out["int8/loss"] = np.array(losses, np.float32)
    put(out, "int8/param", params)


def plain(data, out):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    steps = int(data["plain/steps"])
    bundle = MA.build(cfg, RunConfig(remat="none"))
    opt_cfg = OptConfig(lr=float(data["lr"]), total_steps=steps)
    params = T.init_lm(jax.random.PRNGKey(0), cfg)
    opt = init_opt(opt_cfg, params)
    jstep = jax.jit(make_train_step(bundle, opt_cfg,
                                    int(data["plain/microbatches"])))
    dcfg = lm_data(data, cfg, "plain")
    losses = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in batch_at(dcfg, s).items()}
        params, opt, m = jstep(params, opt, batch)
        losses.append(float(m["loss"]))
    out["plain/loss"] = np.array(losses, np.float32)
    put(out, "plain/param", params)


def main(inputs, out_path):
    assert len(jax.devices()) == 4, jax.devices()
    data, out = np.load(inputs), {}
    for part in (dlrm, compression, int8_ef, plain):
        part(data, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
