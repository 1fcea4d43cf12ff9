"""Seq2seq LSTM building blocks with Luong attention, batch-first.

Ported from ``src/repro/core/lstm.py`` (lines 1-60).  The JAX package
writes each block for one window and ``vmap``s it; here the batch
dimension is written out: ``x`` is (B, in), ``h``/``c`` are (B, H) and
sequences are (B, T, ...).  ``lstm_step`` goes through
:func:`repro_torch.kernels.ops.lstm_cell`, so every LSTM step of the
caching, prefetch and Voyager models, in training and in inference, runs
the CUDA ``lstm_cell`` kernel on the card (the plain version on the CPU).

The parameters live in small ``nn.Module``s that keep the JAX tree's names
(``w`` (in+H, 4H) and ``b`` (4H,) of an LSTM layer, ``wa`` (H, H) of an
attention layer), so a model's state-dict keys are the JAX tree's paths
joined by dots, and :func:`params_from_jax` carries a JAX tree (the
caching, prefetch or Voyager model's, lists of blocks included) into the
module one to one.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops


class LSTMLayer(nn.Module):
    """Parameters of one LSTM layer: ``w`` (in+H, 4H), ``b`` (4H,), gates
    in the order i, f, g, o."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim + hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))

    @property
    def hidden(self) -> int:
        return self.b.shape[0] // 4


class Attention(nn.Module):
    """Parameters of Luong general attention: ``wa`` (H, H)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.wa = nn.Parameter(torch.zeros(hidden, hidden))


def lstm_init(layer: LSTMLayer, gen: torch.Generator) -> LSTMLayer:
    """``lstm_init`` of the JAX package, drawn from ``gen``: w ~ N(0, 1) /
    sqrt(in+H), b = 0 with the forget-gate bias 1.0 (standard
    stabilization)."""
    k, g4 = layer.w.shape
    hid = g4 // 4
    with torch.no_grad():
        layer.w.copy_(torch.randn(k, g4, generator=gen) / math.sqrt(k))
        layer.b.zero_()
        layer.b[hid:2 * hid] = 1.0
    return layer


def attn_init(layer: Attention, gen: torch.Generator) -> Attention:
    """wa ~ N(0, 1) / sqrt(H), drawn from ``gen``."""
    hid = layer.wa.shape[0]
    with torch.no_grad():
        layer.wa.copy_(torch.randn(hid, hid, generator=gen) / math.sqrt(hid))
    return layer


def lstm_step(p: LSTMLayer, carry: Tuple[torch.Tensor, torch.Tensor],
              x: torch.Tensor):
    """One step: ``((h', c'), h')`` from ``carry = (h, c)``, x: (B, in)."""
    h, c = carry
    h2, c2 = ops.lstm_cell(x, h, c, p.w, p.b)
    return (h2, c2), h2


def lstm_seq(p: LSTMLayer, xs: torch.Tensor,
             h0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """xs: (B, T, in) -> ``(hs (B, T, H), (h_T, c_T))``; the state starts
    from zeros unless ``h0`` is given."""
    if h0 is None:
        z = xs.new_zeros((xs.shape[0], p.hidden))
        h0 = (z, z)
    carry, hs = h0, []
    for t in range(xs.shape[1]):
        carry, h = lstm_step(p, carry, xs[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), carry


def attend(p: Attention, h_dec: torch.Tensor, enc_hs: torch.Tensor):
    """Luong general attention.  h_dec: (B, H), enc_hs: (B, T, H) -> ctx
    (B, H).  Per window the JAX package scores ``enc_hs @ (wa @ h)``;
    batched, ``wa @ h`` is ``h @ wa.T``."""
    scores = torch.einsum("bth,bh->bt", enc_hs, h_dec @ p.wa.t())
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bt,bth->bh", w, enc_hs)


def params_from_jax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX parameter tree (nested dicts and lists of arrays, as
    NumPy) into ``module``: each leaf goes to the parameter named by its
    path joined with dots, a list item by its index (JAX's ``tblocks[0]
    ["wq"]`` is ``tblocks.0.wq`` under an ``nn.ModuleList``).  Keys must
    match exactly both ways.  Returns ``module``."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            flat[prefix[:-1]] = torch.from_numpy(np.array(node,
                                                           np.float32))

    walk("", tree)
    ref = module.state_dict()
    flat = {k: v.to(ref[k].device) if k in ref else v
            for k, v in flat.items()}
    module.load_state_dict(flat, strict=True)
    return module
