"""One rank's step of a dry-run cell, run on the ``meta`` device and
counted: the port's counterpart of ``src/repro/launch/hlo_analysis.py`` and
of the traced half of JAX's ``launch/dryrun.py::lower_cell`` (:120-168).

JAX lowers a cell for 512 placeholder devices and reads what XLA made of
it: ``memory_analysis``, ``cost_analysis`` and the HLO text, whose
collectives, dots and bytes ``hlo_analysis.py`` scales by the trip counts
of its while loops.  The port has no compiler between its program and the
card: the eager step is the program.  So :func:`account` runs the rank's
real step, built by ``build(..., mesh=virtual_mesh(...))`` as a user's
rank builds it (``launch/steps.py::make_train_step`` with AdamW, the
sharded prefill or decode, whisper's ``encdec_*_sharded``), on ``meta``
tensors inside the cell's ``activation_sharding`` scope, under a
``TorchDispatchMode`` that sees every op.  Nothing is allocated and no
process group exists: the virtual mesh's collectives record what they
would move (:mod:`repro_torch.distributed.collectives`) and each kernel
wrapper charges its work (:mod:`repro_torch.kernels.work`) in place of a
launch.

JAX's keys and the counts that fill them here:

- ``collectives`` (``collective_stats``): the recorder's
  ``bytes_<op>``/``count_<op>`` over the step, result bytes (an
  all-reduce's twice), and ``collective_bytes``;
- ``hlo_dot_flops`` -> ``cost["dot_flops"]``: 2 M N K of every matrix
  product (``torch.utils.flop_counter``'s formulas: ``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, the ``einsum``s and ``@``s they come from) plus
  each kernel's operations (its ``work``: the attention's products over
  the visible keys, the scan's);
- ``hlo_bytes_accessed`` -> ``cost["bytes_accessed"]``: each op's input
  tensors read and outputs written, views and allocations moving nothing,
  plus each kernel's bytes: an eager program's traffic, op by op (no
  fusion to scale by);
- ``memory_analysis``: ``argument_size_in_bytes`` the storages the step
  takes (the rank's parameters, AdamW's moments, the batch or token, the
  decode cache); ``output_size_in_bytes`` those it gives back (a train
  step's parameters and moments, updated in place, and its metrics; a
  prefill's logits and cache; a decode's logits and the cache written in
  place); ``alias_size_in_bytes`` the outputs that are arguments updated
  in place (JAX's donated buffers); ``temp_size_in_bytes`` the peak of
  the bytes the step allocates, less its new outputs.  So argument +
  output + temp - alias is the peak a rank holds (``roofline_row``'s
  ``hbm_gb_per_dev``), and ``peak_new_bytes`` the step's own allocations
  at their peak, what ``torch.cuda.max_memory_allocated`` reads above the
  bytes held before the step (``chip_smoke.py`` compares the two).

Values the ``meta`` device cannot give take their upper bound (the
distinct ids of a lookup's backward: every id distinct); ``bounded``
lists the sites.  The traced rank is the model rank of most work (the
last: under a sequence split its queries see the most keys; it owns a
full decode cache's newest slot), data rank 0.

A meta op costs ~150 us on the host, so a cell of 64 layers x 16
microbatches is not traced whole: its counts (FLOPs, bytes, collectives,
the arguments' and outputs' bytes) come from traces at 2 and 3 layers
(whisper: of each stack) and, with more than 3 microbatches, at 2 and 3
microbatches of the cell's microbatch rows, each count fitted by ``a + b
L + M (c + e L)`` and read at the cell's depth L and microbatches M, as
``hlo_analysis.py:87-128`` scales a loop body by its trip count.  The
layers of an arch are identical and each microbatch repeats the same
ops, so the fit is exact.  The peak is a max, not a sum (a small model's
is its head's, a deep one's its layers'), so it comes from one more
trace at the cell's depth and 2 microbatches: each microbatch frees what
the one before it allocated (``tests/test_torch_accounting.py`` holds
both against whole traces).
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as M
from repro_torch.kernels import work as W
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.model_api import build
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.sharding import partition as SP
from repro_torch.tree import leaves

_aten = torch.ops.aten
# Ops that allocate without writing, or only describe a tensor.
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.new_empty.default, _aten.new_empty_strided.default,
               _aten.empty_like.default}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors: Iterable[torch.Tensor]) -> Tuple[int, set]:
    """The bytes of the distinct storages under ``tensors``, and their
    keys."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        key = st._cdata
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total, seen


class Meter(TorchDispatchMode):
    """Counts what the ops run inside it do: matrix-product FLOPs, bytes
    read and written, the bytes of fresh storages alive (their peak), and
    the kernels' charges and bounded sites (:mod:`repro_torch.kernels.
    work`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.bounded: set = set()
        self._fresh = weakref.WeakSet()  # the storages allocated inside

    def kernel(self, name: str, work: W.Work) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "ops": 0,
                                             "bytes": 0})
        rec["calls"] += 1
        rec["ops"] += work.ops
        rec["bytes"] += work.bytes
        self.flops += work.ops
        self.bytes += work.bytes

    def bound(self, site: str) -> None:
        self.bounded.add(site)

    def _free(self, n: int) -> None:
        self.live -= n

    def is_fresh(self, t: torch.Tensor) -> bool:
        return t.untyped_storage() in self._fresh

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # An op with a decomposition (under inference_mode the
            # implicit ones, matmul and the like, arrive whole) is counted
            # by the ops it decomposes into, as FlopCounterMode counts it.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        rets = func._schema.returns
        outs = list(_tensors(out))
        aliased = [r.alias_info is not None for r in rets]
        if len(rets) == 1:
            aliased = aliased * len(outs)
        if all(aliased) and not any(r.alias_info.is_write for r in rets):
            return out  # a view: no op, no bytes
        if func not in _NO_TRAFFIC:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t, alias in zip(outs, aliased):
            st = t.untyped_storage()
            if alias or st in self._fresh:
                continue
            n = st.nbytes()
            self._fresh.add(st)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def trace(fn, arguments: Sequence[torch.Tensor], outputs) -> Dict:
    """Runs ``fn()`` under a :class:`Meter`, the collectives' recorder
    counting from zero (a trace leaves ``TRAFFIC`` and ``RECORD`` as it
    found them); ``arguments`` are the tensors it takes, ``outputs(result)``
    the tensors it gives back.  Returns ``{"counts": the flat counts,
    "bounded": the sites}``."""
    saved = copy.deepcopy((C.TRAFFIC, C.RECORD))
    C.reset_record()
    meter = Meter()
    try:
        with W.metering(meter), meter:
            result = fn()
        stats = C.collective_stats()
    finally:  # the counters read as if the trace had not run
        C.TRAFFIC.update(saved[0])
        C.RECORD.update(saved[1])
    arg_bytes, arg_keys = _storage_bytes(arguments)
    outs = list(_tensors(outputs(result)))
    out_bytes, _ = _storage_bytes(outs)
    alias, _ = _storage_bytes(t for t in outs
                              if t.untyped_storage()._cdata in arg_keys)
    fresh, _ = _storage_bytes(t for t in outs if meter.is_fresh(t))
    counts = {"dot_flops": meter.flops, "bytes_accessed": meter.bytes,
              "argument": arg_bytes, "output": out_bytes, "alias": alias,
              "fresh_output": fresh, "peak_new": meter.peak}
    for k, v in stats.items():
        counts[f"collectives/{k}"] = v
    for name, rec in meter.kernels.items():
        for k, v in rec.items():
            counts[f"kernels/{name}/{k}"] = v
    return {"counts": counts, "bounded": sorted(meter.bounded)}


def traced_rank(mesh_shape: Dict[str, int]) -> int:
    """The rank of most work: data rank 0, the last model rank."""
    return mesh_shape["model"] - 1


def _batch(bundle, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(dims, dtype=dt, device="meta")
            for k, (dims, dt) in bundle.batch_struct(shape).items()}


def _opt_state(opt) -> List[torch.Tensor]:
    return [t for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]


def trace_step(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
               mesh: M.Mesh, microbatches: int = 1,
               cache_len: Optional[int] = None,
               pos: Optional[int] = None) -> Dict:
    """One whole trace of ``shape``'s step on ``mesh`` (a virtual mesh:
    its rank's step) with ``cfg`` as given.  ``cache_len``: a prefill's
    cache capacity (the sequence by default); ``pos``: a decode's
    position (the cache's last slot by default), its cache
    ``shape.seq_len`` slots."""
    bundle = build(cfg, device="meta", run=run, mesh=mesh)
    params = bundle.init(seed=0)
    batch = _batch(bundle, shape)
    scope = M.activation_sharding(mesh, run.sharding)
    if shape.kind == "train":
        opt = init_opt(OptConfig(), leaves(params))
        from repro_torch.launch.steps import make_train_step

        step = make_train_step(bundle, microbatches, mesh)

        def fn():
            with scope:
                return step(params, opt, batch)

        return trace(fn, leaves(params) + _opt_state(opt)
                     + list(batch.values()),
                     lambda m: (leaves(params), _opt_state(opt),
                                [m["loss"], m["grad_norm"]]))
    if shape.kind == "prefill":
        if cfg.family == "dlrm":  # the serve takes the rank's rows
            batch = {k: M.batch_shard(v, mesh, run.sharding)
                     for k, v in batch.items()}
            rows = SP.batch_axes(tuple(batch["sparse"].shape), mesh,
                                 run.sharding)[0]
            scope = M.activation_sharding(mesh, run.sharding, rows=rows)

            def fn():
                with scope:
                    return bundle.prefill(params, batch)

            return trace(fn, leaves(params) + list(batch.values()),
                         lambda r: [r])

        def fn():
            with scope:
                return bundle.prefill(params, batch, cache_len)

        return trace(fn, leaves(params) + list(batch.values()),
                     lambda r: (r[0], r[1]))
    cap = shape.seq_len
    pos = cap - 1 if pos is None else pos
    b = shape.global_batch
    cache = (ED.rank_cache(cfg, run, mesh, b, cap, pos, "meta")
             if cfg.enc_dec
             else T.rank_cache(cfg, run, mesh, b, cap, pos, "meta"))
    token = batch["token"]

    def fn():
        with scope:
            return bundle.decode(params, token, cache)

    return trace(fn, leaves(params) + [token] + list(_tensors(cache)),
                 lambda r: (r[0], r[1]))


def _depth(cfg: ModelConfig, n: int) -> ModelConfig:
    kw = {"n_layers": n}
    if cfg.enc_dec:
        if cfg.n_enc_layers != cfg.n_layers:
            raise NotImplementedError(
                f"{cfg.name}: the depth fit takes equal encoder and decoder "
                f"stacks, not {cfg.n_enc_layers} and {cfg.n_layers}")
        kw["n_enc_layers"] = n
    return dataclasses.replace(cfg, **kw)


def _fit(points: Dict[Tuple[int, int], Dict[str, float]], depth: int,
         mb: int) -> Dict[str, float]:
    """Each count at ``(depth, mb)``, linear in each of the two from the
    traces at two adjacent depths and two adjacent microbatch counts (or
    one of either): ``a + b L + M (c + e L)``."""
    keys = sorted(set().union(*points.values()))
    ds = sorted({d for d, _ in points})
    ms = sorted({m for _, m in points})

    def weights(xs, x):  # integer weights: the points lie 1 apart
        return [(xs[0], 1)] if len(xs) == 1 else [(xs[0], xs[1] - x),
                                                  (xs[1], x - xs[0])]

    return {k: sum(wd * wm * points[(d, m)].get(k, 0)
                   for d, wd in weights(ds, depth)
                   for m, wm in weights(ms, mb)) for k in keys}


def fitted(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
           mesh: M.Mesh, microbatches: int = 1,
           cache_len: Optional[int] = None,
           pos: Optional[int] = None) -> Dict:
    """The flat counts of ``mesh``'s rank in one step of ``shape``:
    fitted from traces at 2-3 layers and 2-3 microbatches where the cell
    has more, the peak from a trace at the cell's depth (the module's
    docstring).  Returns ``{"counts", "bounded", "traced": the (layers,
    microbatches) traced}``."""
    layered = cfg.family != "dlrm"
    depth = cfg.n_layers if layered else 0
    mb_rows = shape.global_batch // max(microbatches, 1)
    ds = (2, 3) if layered and depth > 3 else (depth,)
    ms = (2, 3) if microbatches > 3 else (microbatches,)
    # The peak is a max over the step, not a sum: it is read from a trace
    # at the cell's depth, at 2 microbatches where there are more (each
    # microbatch frees what the one before it allocated).
    peak_at = (depth, 2 if len(ms) > 1 else microbatches)
    traced = {}
    bounded = set()
    for d, m in {(d, m) for d in ds for m in ms} | {peak_at}:
        c = _depth(cfg, d) if layered and d != depth else cfg
        s = (dataclasses.replace(shape, global_batch=m * mb_rows)
             if m != microbatches else shape)
        res = trace_step(c, s, run, mesh, m, cache_len, pos)
        traced[(d, m)] = res["counts"]
        bounded.update(res["bounded"])
    counts = _fit({p: traced[p] for p in traced
                   if p[0] in ds and p[1] in ms}, depth, microbatches)
    counts["peak_new"] = traced[peak_at]["peak_new"]
    return {"counts": counts, "bounded": sorted(bounded),
            "traced": sorted(traced)}


def account(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
            mesh_shape: Dict[str, int], microbatches: int = 1,
            rank: Optional[int] = None, cache_len: Optional[int] = None,
            pos: Optional[int] = None) -> Dict:
    """What rank ``rank`` (:func:`traced_rank` by default) of a
    ``(data, model)`` mesh does in one step of ``shape`` with
    ``microbatches`` (:func:`fitted`): ``{"rank", "collectives", "cost",
    "memory_analysis", "kernels", "bounded", "traced"}`` (the module's
    keys)."""
    rank = traced_rank(mesh_shape) if rank is None else rank
    mesh = M.virtual_mesh(mesh_shape["data"], mesh_shape["model"], rank)
    fit = fitted(cfg, shape, run, mesh, microbatches, cache_len, pos)
    counts = fit["counts"]
    coll = {k.split("/", 1)[1]: int(v) for k, v in counts.items()
            if k.startswith("collectives/")}
    kernels: Dict[str, Dict[str, int]] = {}
    for k, v in counts.items():
        if k.startswith("kernels/"):
            _, name, field = k.split("/")
            kernels.setdefault(name, {})[field] = int(v)
    fresh, peak_new = int(counts["fresh_output"]), int(counts["peak_new"])
    memory = {"argument_size_in_bytes": int(counts["argument"]),
              "output_size_in_bytes": int(counts["output"]),
              "temp_size_in_bytes": max(peak_new - fresh, 0),
              "alias_size_in_bytes": int(counts["alias"]),
              "peak_new_bytes": peak_new}
    return {"rank": rank, "collectives": coll,
            "cost": {"dot_flops": int(counts["dot_flops"]),
                     "bytes_accessed": int(counts["bytes_accessed"])},
            "memory_analysis": memory, "kernels": kernels,
            "bounded": fit["bounded"],
            "traced": [f"{d} layers x {m} microbatches"
                       for d, m in fit["traced"]]}


def folded(mesh_shape: Dict[str, int]) -> Dict[str, int]:
    """A (pod, data, model) mesh with ``pod`` folded into ``data``."""
    return {"data": mesh_shape.get("pod", 1) * mesh_shape["data"],
            "model": mesh_shape["model"]}


def fold_differences(model, batch: Dict, cache: Optional[Dict],
                     run: RunConfig, mesh_shape: Dict[str, int]) -> List[str]:
    """The leaves (parameters of ``model``, batch and decode-cache leaves)
    that the (pod, data, model) mesh ``mesh_shape`` lays out otherwise
    than :func:`folded` does: a spec entry over ``("pod", "data")`` must
    be ``"data"`` there, and one over ``pod`` alone has no fold."""
    pod, flat = mesh_shape, folded(mesh_shape)

    def fold(spec):
        out = []
        for e in spec:
            axes = SP.axes_of(e)
            if "pod" in axes:
                if axes[:2] != ("pod", "data"):
                    return None
                axes = ("data",) + axes[2:]
            out.append(None if not axes else axes[0] if len(axes) == 1
                       else axes)
        return tuple(out)

    diff = []
    a = SP.param_specs(model, pod, run.sharding, run.emb_rows)
    b = SP.param_specs(model, flat, run.sharding, run.emb_rows)
    diff += [f"param {n}" for n in a if fold(a[n]) != b[n]]
    for k, (dims, _) in batch.items():
        if fold(SP.batch_spec(dims, pod, run.sharding)) != SP.batch_spec(
                dims, flat, run.sharding):
            diff.append(f"batch {k}")
    if cache is not None:
        for k, t in cache.items():
            dims = tuple(t.shape)[1:]
            if fold(SP.cache_spec(k, dims, pod, run.shard_kv_seq)) != \
                    SP.cache_spec(k, dims, flat, run.shard_kv_seq):
                diff.append(f"cache {k}")
    return diff
