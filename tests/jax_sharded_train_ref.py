"""The JAX package's side of ``tests/test_torch_sharded_train.py``: run as
a script in a process of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.

    python tests/jax_sharded_train_ref.py INPUTS.npz OUT.npz [PART/PARTS]

(with ``PART/PARTS``, the cases whose index modulo PARTS is PART).

For each case of the inputs (``arch|sharding|data|model``, a DLRM case
with ``|sharded`` or ``|dense``, its lookup; options ``|B=``, ``|S=``,
the batch and sequence, ``|local``, ``moe_local_dispatch``, and
``|bf16``): the reduced arch's ``build(cfg).init(PRNGKey(0))`` (in bf16
the fp32 draws cast) placed by
``param_pspecs`` (DLRM's tables by ``emb_rows="all"``) on a (data,
model) mesh of Auto axes over the four CPU devices, AdamW's state by
``opt_struct_and_specs``, and
``make_train_step`` jitted with those shardings (two microbatches, the
case's variant under ``activation_sharding``) over ``batch_at``'s batches
(whisper's with the inputs' audio frames; DLRM's the inputs' batches).
Writes each step's loss and grad norm, and each device's shard of every
parameter and of the moments after the last step, keyed by the rank at
the device's mesh position (``mesh.devices``) and the port's leaf name
(the stacked layer axes unrolled).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from jax_dist_train_ref import STACKED, make_mesh
from repro.configs import RunConfig, get_config
from repro.data.lm_data import LMDataConfig, batch_at
from repro.launch.steps import make_train_step, opt_struct_and_specs
from repro.models import model_api as MA
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
            if names[0] in STACKED:
                for i in range(data.shape[0]):
                    key = ".".join([names[0], str(i)] + names[1:])
                    out[f"{prefix}/r{rank}/{key}"] = data[i]
            else:
                out[f"{prefix}/r{rank}/{'.'.join(names)}"] = data


def case_opts(case):
    """A case's options after ``arch|sharding|data|model``: ``{"B": n,
    "S": n}`` where given, and its flags (``local``, DLRM's lookup)."""
    out = {}
    for opt in case.split("|")[4:]:
        key, _, val = opt.partition("=")
        out[key] = int(val) if val else True
    return out


def batches(data, arch, cfg, steps, opts):
    """The case's batches: DLRM's from the inputs, an LM's ``batch_at``'s
    (with whisper's frames from the inputs) at the case's ``S`` and ``B``
    where it gives them."""
    if cfg.family == "dlrm":
        return [{k: jnp.asarray(data[f"dlrm/{s}/{k}"])
                 for k in ("dense", "sparse", "label")} for s in range(steps)]
    dcfg = LMDataConfig(vocab=cfg.vocab,
                        seq_len=opts.get("S", int(data["seq"])),
                        global_batch=opts.get("B", int(data["batch"])))
    out = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in batch_at(dcfg, s).items()}
        if cfg.enc_dec:
            b["frontend"] = jnp.asarray(data[f"frames/{arch}/{s}"])
        out.append(b)
    return out


def run_case(data, case, out):
    arch, sharding, nd, nm = case.split("|")[:4]
    opts = case_opts(case)
    fp32 = get_config(arch).reduced()
    dtype = "bfloat16" if "bf16" in opts else "float32"
    cfg = dataclasses.replace(fp32, param_dtype=dtype, compute_dtype=dtype)
    steps, mb = int(data["steps"]), int(data["microbatches"])
    run = RunConfig(remat="none", sharding=sharding,
                    dlrm_sharded_lookup="sharded" in opts,
                    moe_local_dispatch="local" in opts)
    bundle = MA.build(cfg, run)
    opt_cfg = OptConfig(lr=float(data["lr"]), total_steps=steps)
    mesh = make_mesh((int(nd), int(nm)))
    pspecs = sp.param_pspecs(bundle.param_struct(), mesh, sharding)
    param_sh = sp.to_shardings(pspecs, mesh)
    _, opt_pspecs = opt_struct_and_specs(bundle, pspecs, opt_cfg)
    opt_sh = sp.to_shardings(opt_pspecs, mesh)
    # The fp32 arch's draws, cast to the case's dtype leaf by leaf (the
    # port copies the same fp32 draws).
    params = jax.device_put(jax.tree.map(
        lambda a, s: a.astype(s.dtype),
        MA.build(fp32, run).init(jax.random.PRNGKey(0)),
        bundle.param_struct()), param_sh)
    opt = jax.jit(lambda p: init_opt(opt_cfg, p), out_shardings=opt_sh)(
        params)
    losses, norms = [], []
    with mesh, sp.activation_sharding(mesh, sharding):
        step = jax.jit(make_train_step(bundle, opt_cfg, mb, mesh),
                       in_shardings=(param_sh, opt_sh, None),
                       out_shardings=(param_sh, opt_sh, None))
        for batch in batches(data, arch, cfg, steps, opts):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"{case}/loss"] = np.array(losses, np.float32)
    out[f"{case}/grad_norm"] = np.array(norms, np.float32)
    put_shards(out, f"{case}/param", params, mesh)
    put_shards(out, f"{case}/m", opt["m"], mesh)
    put_shards(out, f"{case}/v", opt["v"], mesh)


def main(inputs, out_path, part="0/1"):
    assert len(jax.devices()) == 4, jax.devices()
    data, out = np.load(inputs), {}
    index, parts = (int(x) for x in part.split("/"))
    cases = list(data["cases"]) + list(data["dlrm_cases"])
    for case in cases[index::parts]:
        run_case(data, str(case), out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
