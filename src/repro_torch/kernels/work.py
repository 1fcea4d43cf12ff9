"""The work of each kernel of the port: the operations it must do and the
bytes it must move (each input read once, each output written once), one
function a kernel.

Two readers use the same function, so they cannot drift apart:
``chip_smoke.py`` divides a kernel's work by the card's peak rates for the
bound of its row in ``PERF.md`` (section 6), and on the ``meta`` device
each wrapper charges its work to the active meters (:func:`charge`) in
place of its launch, which the dry-run's accounting
(:mod:`repro_torch.launch.accounting`) sums beside the plain ops it
traces.  :attr:`Work.dtype` says which peak the operations run at: the
attention's bf16 products on the tensor cores, everything else fp32.

Where the work depends on the data (the distinct rows a gather reads, the
ids a shard owns), a tensor with values gives its count and a ``meta``
tensor the upper bound (every id distinct and owned, at most the table's
rows), which :func:`note_bound` reports to the meters by the site's
name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

# The H100 SXM5's streaming multiprocessors, and the compile-time layout of
# the scan kernels (csrc/selective_scan.cu's kTile; the backward's block of
# channels): what the wrappers read from the card and the libraries, given
# on the meta device, where neither exists.
H100_SMS = 132
SCAN_STATE_CHUNK = 16
SCAN_BWD_CHANNELS = 64


@dataclass(frozen=True)
class Work:
    """A kernel call's operations and bytes; ``dtype`` the operations'
    type (``"bf16"``: tensor-core products; ``"fp32"``)."""
    ops: float
    bytes: float
    dtype: str = "fp32"


_METERS: List = []


def charge(name: str, work: Work) -> None:
    """Adds a kernel call's work to every active meter (on ``meta``)."""
    for m in _METERS:
        m.kernel(name, work)


def note_bound(site: str) -> None:
    """Tells the active meters that ``site`` took an upper bound for a
    value the ``meta`` device cannot give."""
    for m in _METERS:
        m.bound(site)


class metering:
    """Scope in which ``meter`` (an object with ``kernel(name, work)`` and
    ``bound(site)``) receives the charges."""

    def __init__(self, meter):
        self.meter = meter

    def __enter__(self):
        _METERS.append(self.meter)
        return self.meter

    def __exit__(self, *exc):
        _METERS.remove(self.meter)
        return False


def n_distinct(t: torch.Tensor, limit: int, site: str) -> int:
    """The distinct values of ``t``; on ``meta`` the upper bound
    ``min(t.numel(), limit)``."""
    if t.is_meta:
        note_bound(site)
        return min(t.numel(), limit)
    return int(torch.unique(t).numel())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> Work:
    """The distinct rows read once, each output row written once, the ids
    read once."""
    rb = table.shape[1] * table.element_size()
    rows = n_distinct(idx, table.shape[0], "work.gather_rows")
    return Work(0, rows * rb + idx.numel() * (rb + 4))


def gather_rows_expand(table: torch.Tensor, slots: torch.Tensor,
                       inv: torch.Tensor, ov: Optional[torch.Tensor] = None,
                       quantized: bool = False) -> Work:
    """The store's fused read: each distinct buffer row read once (``D +
    4`` bytes with its scale when quantized), each overflow row read once,
    each output row written once, the index vectors read once; one
    multiply per dequantized element.  On ``meta`` every slot counts as a
    distinct buffer row and as an overflow row."""
    d = table.shape[1]
    rb_out = d * (4 if quantized else table.element_size())
    rb_in = d * table.element_size() + (4 if quantized else 0)
    extra = 0 if ov is None else ov.numel()
    if inv.is_meta:
        note_bound("work.gather_rows_expand")
        rows_read = min(slots.numel(), table.shape[0])
        ov_read = 0 if ov is None else slots.numel()
    else:
        used = torch.unique(inv).long()
        if ov is None:
            rows_read, ov_read = int(torch.unique(slots[used]).numel()), 0
        else:
            keep = ~ov[used]
            rows_read = int(torch.unique(slots[used[keep]]).numel())
            ov_read = int((~keep).sum())
    n_bytes = (rows_read * rb_in + ov_read * rb_out + inv.numel() * rb_out
               + inv.numel() * 4 + slots.numel() * 4 + extra)
    return Work(inv.numel() * d if quantized else 0, n_bytes)


def gather_rows_dequant(table: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor) -> Work:
    """The distinct code rows and their scales read once, each fp32
    output row written once, the ids read once; one multiply an
    element."""
    d = table.shape[1]
    rows = n_distinct(idx, table.shape[0], "work.gather_rows_dequant")
    return Work(idx.numel() * d, rows * (d + 4) + idx.numel() * (4 * d + 4))


def gather_pool(table: torch.Tensor, idx: torch.Tensor,
                quantized: bool = False) -> Work:
    """A pooled read: distinct rows read once (with their scale when
    quantized), ids read once, the fp32 sums written once; one add per
    gathered element, and one multiply more when dequantizing."""
    b, p = idx.shape
    d = table.shape[1]
    rb_in = d * table.element_size() + (4 if quantized else 0)
    rows = n_distinct(idx, table.shape[0], "work.gather_pool")
    return Work((2 if quantized else 1) * b * p * d,
                rows * rb_in + idx.numel() * 4 + b * d * 4)


def gather_pool_shard(table: torch.Tensor, idx: torch.Tensor) -> Work:
    """The shard window: the distinct owned rows read once, the ids read
    once, the fp32 sums written once; one add per owned id and element (a
    skipped id reads no row).  On ``meta`` every id counts as owned."""
    b, _ = idx.shape
    d = table.shape[1]
    if idx.is_meta:
        note_bound("work.gather_pool_shard")
        owned = idx.numel()
        rows = min(owned, table.shape[0])
    else:
        ids = idx[idx >= 0]
        owned, rows = ids.numel(), int(torch.unique(ids).numel())
    return Work(owned * d, rows * d * table.element_size()
                + idx.numel() * 4 + b * d * 4)


def quantize_scatter(m: int, d: int) -> Work:
    """``m`` rows of ``d`` fp32 read once, their slots read, the codes and
    scales written; three operations an element (abs-max, scale,
    round)."""
    return Work(3 * m * d, m * d * 4 + m * 4 + m * d + m * 4)


def lstm_cell(b: int, in_dim: int, hid: int, save_gates: bool) -> Work:
    """x, h, c, w and the bias read once, h' and c' (and the gates when
    saved) written once, fp32; the (B, in+H) x (in+H, 4H) product."""
    k = in_dim + hid
    n_bytes = 4 * (b * in_dim + 4 * b * hid + k * 4 * hid + 4 * hid
                   + (b * 4 * hid if save_gates else 0))
    return Work(2 * b * k * 4 * hid, n_bytes)


def chamfer(b: int, n_p: int, n_w: int, n_f: int) -> Work:
    """Both point sets read once, the loss and both argmins written; three
    operations a coordinate of every (p, w) pair."""
    return Work(3 * b * n_p * n_w * n_f,
                4 * b * ((n_p + n_w) * n_f + 1 + n_p + n_w))


def visible_pairs(sq: int, sk: int, window: int = 0, causal: bool = True,
                  q_offset: int = 0) -> int:
    """The (query, key) pairs of a (batch, head) that the mask lets
    through: query row i at position ``q_offset + i`` sees keys ``max(0,
    p - window + 1) .. p`` (``window`` 0: every key up to p); unmasked,
    every key."""
    if not causal:
        return sq * sk
    lo, hi = q_offset + 1, q_offset + sq  # keys seen by the first, last row
    w = window if window > 0 else hi
    cut = min(hi, w)
    tri = (cut * (cut + 1) - (lo - 1) * lo) // 2 if cut >= lo else 0
    return tri + w * max(0, hi - max(lo - 1, w))


def flash_attention(b: int, sq: int, sk: int, h: int, n_kv: int, hd: int,
                    elt: int, window: int = 0, causal: bool = True,
                    q_offset: int = 0) -> Work:
    """Two products of 2 hd operations over each visible pair (scores and
    p v); q, k, v read once and o written once."""
    pairs = visible_pairs(sq, sk, window, causal, q_offset)
    return Work(4 * b * h * hd * pairs,
                elt * b * hd * (2 * sq * h + 2 * sk * n_kv),
                "bf16" if elt == 2 else "fp32")


def flash_attention_bwd(b: int, sq: int, sk: int, h: int, n_kv: int,
                        hd: int, elt: int, window: int = 0,
                        causal: bool = True, q_offset: int = 0) -> Work:
    """Five products over each visible pair (the scores again, dv, dp, dq,
    dk); q, k, v, o, dO and the log-sum-exp read once, dq, dk, dv written
    once."""
    pairs = visible_pairs(sq, sk, window, causal, q_offset)
    return Work(10 * b * h * hd * pairs,
                elt * (4 * b * sq * h * hd + 4 * b * sk * n_kv * hd)
                + 4 * b * h * sq, "bf16" if elt == 2 else "fp32")


def selective_scan(b: int, s: int, di: int, n: int, elt: int) -> Work:
    """x and z read and y written in the compute dtype, dt read, Bm and Cm
    read, a and D read, h_last written (fp32); ~8 fp32 operations per
    state and step (dt a, exp, two products and sums) and 8 per channel
    and step (dt x, D x, silu, the gate)."""
    n_bytes = (3 * elt + 4) * b * s * di + 4 * (2 * b * s * n + di * n + di
                                                 + b * di * n)
    return Work(b * s * di * (8 * n + 8), n_bytes)


def selective_scan_bwd(b: int, s: int, di: int, n: int, elt: int) -> Work:
    """The function's own traffic: x, z and dy read and dx, dz written in
    the compute dtype, dt read and ddt written (fp32), Bm, Cm, a, D, h0 and
    dh_last read and their gradients and dh0 written (fp32); ~16 fp32
    operations per state and step (the state, dh, its carry and the four
    gradients' terms) and 16 per channel and step (the gate's and D's).
    The states the forward saves are this design's checkpoint, not the
    function's."""
    n_bytes = (5 * elt + 8) * b * s * di + 4 * (
        4 * b * s * n + 2 * di * n + 2 * di + 3 * b * di * n)
    return Work(b * s * di * (16 * n + 16), n_bytes)
