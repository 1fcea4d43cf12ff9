"""The ``replay`` workload regime: serve an external trace file through
the same ``WorkloadSpec -> trace/batches`` API as the synthetic regimes.

Copied from ``src/repro/workloads/replay.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

    spec = make_spec("replay", path="runs/prod_trace.npz")
    for ids in iter_batches(spec, 256): ...

Files are ``.npz`` or ``.csv`` in the layout of
:func:`repro_torch.core.trace.save_trace`; a trace written by ``save_trace``
round-trips byte-identically (property-tested).  The file's geometry is
authoritative: its table count and per-table row counts replace the
spec's uniform scale fields.  ``n_accesses=0`` means "whole file";
a positive value truncates to that prefix.
"""
from __future__ import annotations

from repro_torch.core.trace import Trace, load_trace
from repro_torch.workloads.spec import WorkloadSpec, register


@register("replay", params=("path",))
def replay(spec: WorkloadSpec, rng) -> tuple:  # pragma: no cover
    # Never called: make_trace dispatches "replay" to make_replay_trace
    # before reaching the generic generator path (a generator can only
    # emit ids into the spec's uniform geometry; the file carries its
    # own).  Registered so the regime shows up in listings/parse errors.
    raise RuntimeError("replay traces load through make_trace")


def make_replay_trace(spec: WorkloadSpec) -> Trace:
    path = spec.param("path")
    if not path:
        raise ValueError("replay spec needs a path param "
                         "(make_spec('replay', path='trace.npz'))")
    tr = load_trace(path)
    n = int(spec.n_accesses or 0)
    if n and n < len(tr):
        tr = tr.slice(0, n)
    return tr
