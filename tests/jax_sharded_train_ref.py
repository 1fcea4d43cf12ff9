"""The JAX package's side of ``tests/test_torch_sharded_train.py``: run as
a script in a process of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.

    python tests/jax_sharded_train_ref.py INPUTS.npz OUT.npz

For each case of the inputs (``arch|sharding|data|model``): the reduced
arch's ``init_lm(PRNGKey(0))`` placed by ``param_pspecs`` on a (data,
model) mesh of Auto axes over the four CPU devices, AdamW's state by
``opt_struct_and_specs``, and ``make_train_step`` jitted with those
shardings (two microbatches, the case's variant under
``activation_sharding``) over ``batch_at``'s batches.  Writes each step's
loss and grad norm, and each device's shard of every parameter and of the
moments after the last step, keyed by the rank at the device's mesh
position (``mesh.devices``) and the port's leaf name (the stacked layer
axis unrolled).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from jax_dist_train_ref import make_mesh
from repro.configs import RunConfig, get_config
from repro.data.lm_data import LMDataConfig, batch_at
from repro.launch.steps import make_train_step, opt_struct_and_specs
from repro.models import model_api as MA
from repro.models import transformer as T
from repro.optim.adamw import OptConfig, init_opt
from repro.sharding import partition as sp


def _names(path):
    return [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]


def put_shards(out, prefix, tree, mesh):
    """``out[prefix/r<rank>/<port leaf name>]``: each device's shard."""
    where = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = _names(path)
        for shard in arr.addressable_shards:
            data = np.asarray(shard.data, np.float32)
            rank = where[shard.device.id]
            if names[0] == "blocks":
                for i in range(data.shape[0]):
                    key = ".".join([names[0], str(i)] + names[1:])
                    out[f"{prefix}/r{rank}/{key}"] = data[i]
            else:
                out[f"{prefix}/r{rank}/{'.'.join(names)}"] = data


def run_case(data, case, out):
    arch, sharding, nd, nm = case.split("|")
    cfg = get_config(arch).reduced()
    steps, mb = int(data["steps"]), int(data["microbatches"])
    bundle = MA.build(cfg, RunConfig(remat="none", sharding=sharding))
    opt_cfg = OptConfig(lr=float(data["lr"]), total_steps=steps)
    mesh = make_mesh((int(nd), int(nm)))
    pspecs = sp.param_pspecs(bundle.param_struct(), mesh, sharding)
    param_sh = sp.to_shardings(pspecs, mesh)
    _, opt_pspecs = opt_struct_and_specs(bundle, pspecs, opt_cfg)
    opt_sh = sp.to_shardings(opt_pspecs, mesh)
    params = jax.device_put(T.init_lm(jax.random.PRNGKey(0), cfg), param_sh)
    opt = jax.jit(lambda p: init_opt(opt_cfg, p), out_shardings=opt_sh)(
        params)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=int(data["seq"]),
                        global_batch=int(data["batch"]))
    losses, norms = [], []
    with mesh, sp.activation_sharding(mesh, sharding):
        step = jax.jit(make_train_step(bundle, opt_cfg, mb, mesh),
                       in_shardings=(param_sh, opt_sh, None),
                       out_shardings=(param_sh, opt_sh, None))
        for s in range(steps):
            batch = {k: jnp.asarray(v) for k, v in batch_at(dcfg, s).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"{case}/loss"] = np.array(losses, np.float32)
    out[f"{case}/grad_norm"] = np.array(norms, np.float32)
    put_shards(out, f"{case}/param", params, mesh)
    put_shards(out, f"{case}/m", opt["m"], mesh)
    put_shards(out, f"{case}/v", opt["v"], mesh)


def main(inputs, out_path):
    assert len(jax.devices()) == 4, jax.devices()
    data, out = np.load(inputs), {}
    for case in data["cases"]:
        run_case(data, str(case), out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
