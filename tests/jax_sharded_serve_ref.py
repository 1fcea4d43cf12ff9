"""The JAX package's side of ``tests/test_torch_sharded_serve.py``: run as
a script in a process of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``.

    python tests/jax_sharded_serve_ref.py INPUTS.npz OUT.npz

For each case of the inputs (``arch|sharding|data|model|shard_kv_seq|
cap``): the reduced arch's ``build(cfg).init(PRNGKey(0))`` placed by
``param_pspecs`` on a (data, model) mesh of Auto axes over the four CPU
devices, the batch by ``batch_pspecs``, and, as ``launch/dryrun.py:104-122``
lowers them, ``bundle.prefill`` (cache capacity ``cap``) and
``bundle.decode`` jitted with those shardings under
``activation_sharding(mesh, sharding)``, the decode cache laid out by
``cache_pspecs(shard_kv_seq)``; three decode steps follow the prefill.
Writes the prefill's and every step's logits (B, V), and each device's
shard of every cache leaf (``k``, ``v``, ``conv``, ``h``, ``xk``, ``xv`` as
the family has them) after the prefill and after the last step, keyed by
the rank at the device's mesh position.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from jax_dist_train_ref import make_mesh
from repro.configs import RunConfig, get_config
from repro.models import model_api as MA
from repro.sharding import partition as sp


def case_cfg(arch):
    """The reduced arch; hymba's window cut to 6, so its ring of keys is
    shorter than the prompt."""
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, window=6) if cfg.family == "hybrid" \
        else cfg


def put_cache(out, prefix, cache, mesh):
    where = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
    for name in sorted(k for k in cache if k != "pos"):
        for shard in cache[name].addressable_shards:
            out[f"{prefix}/r{where[shard.device.id]}/{name}"] = np.asarray(
                shard.data, np.float32)


def run_case(data, case, out):
    arch, sharding, nd, nm, kv_seq, cap = case.split("|")
    cfg = case_cfg(arch)
    cap = int(cap)
    run = RunConfig(sharding=sharding, shard_kv_seq=kv_seq == "1")
    bundle = MA.build(cfg, run)
    mesh = make_mesh((int(nd), int(nm)))
    param_sh = sp.to_shardings(sp.param_pspecs(
        bundle.param_struct(), mesh, sharding), mesh)
    params = jax.device_put(bundle.init(jax.random.PRNGKey(0)), param_sh)
    batch = {"tokens": jnp.asarray(data[f"{case}/tokens"])}
    if f"{case}/frontend" in data:
        batch["frontend"] = jnp.asarray(data[f"{case}/frontend"])
    batch_sh = sp.to_shardings(sp.batch_pspecs(batch, mesh, sharding), mesh)
    steps = data[f"{case}/steps"]
    with mesh, sp.activation_sharding(mesh, sharding):
        logits, cache = jax.jit(
            lambda p, b: bundle.prefill(p, b, cap),
            in_shardings=(param_sh, batch_sh))(
                params, jax.device_put(batch, batch_sh))
        cache_sh = sp.to_shardings(
            sp.cache_pspecs(cache, mesh, run.shard_kv_seq), mesh)
        cache = jax.device_put(cache, cache_sh)
        out[f"{case}/logits0"] = np.asarray(logits, np.float32)
        put_cache(out, f"{case}/prefill", cache, mesh)
        token_sh = sp.to_shardings(sp.batch_pspecs(
            jnp.zeros(steps.shape[1:], jnp.int32), mesh, sharding), mesh)
        decode = jax.jit(bundle.decode,
                         in_shardings=(param_sh, token_sh, cache_sh),
                         out_shardings=(None, cache_sh))
        for i, tok in enumerate(steps):
            logits, cache = decode(params, jax.device_put(
                jnp.asarray(tok), token_sh), cache)
            out[f"{case}/logits{i + 1}"] = np.asarray(logits, np.float32)
        put_cache(out, f"{case}/decode", cache, mesh)


def main(inputs, out_path):
    assert len(jax.devices()) == 4, jax.devices()
    data, out = np.load(inputs), {}
    for case in data["cases"]:
        run_case(data, str(case), out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
