"""The paper's bidirectional Chamfer loss (Eq. 5).

Ported from ``src/repro/core/chamfer.py`` (lines 1-73).

dist(PO, W) = a * mean_{x in PO} min_{y in W} |x-y|
            + (1-a) * mean_{y in W} min_{x in PO} |x-y|

The reverse term prevents the mode-collapse shortcut of one-sided Chamfer
(all outputs predicting the single easiest target — the paper's {1,2,3} vs
{2,6,7,8} example).  alpha = 0.7 per the paper.

``chamfer_bidirectional_vec``, the prefetch model's training loss, goes
through :func:`repro_torch.kernels.ops.chamfer`: the CUDA ``chamfer``
kernel on the card, with its backward.  The other functions stay plain
tensor code, as the JAX package computes them outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def pairwise_abs(po, w):
    """po: (..., P), w: (..., W) -> (..., P, W)."""
    return (po[..., :, None] - w[..., None, :]).abs()


def chamfer_forward(po, w):
    """One-sided d_CM(PO, W) (Eq. 4), mean over PO. Shapes (..., P), (..., W)."""
    return pairwise_abs(po, w).amin(dim=-1).mean(dim=-1)


def chamfer_bidirectional(po, w, alpha: float = 0.7):
    """Eq. 5, already normalized by |PO| and |W|.  Returns (...,)."""
    d = pairwise_abs(po, w)
    fwd = d.amin(dim=-1).mean(dim=-1)  # each PO point -> nearest W
    bwd = d.amin(dim=-2).mean(dim=-1)  # each W point -> nearest PO
    return alpha * fwd + (1.0 - alpha) * bwd


def l2_truncated(po, w):
    """Ablation baseline (paper Fig. 11): elementwise L2 against the first
    |PO| ground-truth accesses (evaluation window == output length)."""
    wt = w[..., : po.shape[-1]]
    return ((po - wt) ** 2).mean(dim=-1)


# ---------------------------------------------------------------------------
# Vector-space (learned-representation) variants.
#
# The prefetch model predicts points in the encoder's dense representation
# space and the Chamfer measure compares the predicted set against the
# window's representations.  Squared L2 keeps Eq. 4/5's structure and
# allows matmul-based nearest-neighbor decode at deployment.
# ---------------------------------------------------------------------------


def pairwise_sqdist(po, w):
    """po: (..., P, F), w: (..., W, F) -> (..., P, W) squared L2."""
    d = po[..., :, None, :] - w[..., None, :, :]
    return (d * d).sum(dim=-1)


def chamfer_bidirectional_vec(po: torch.Tensor, w: torch.Tensor,
                              alpha: float = 0.7) -> torch.Tensor:
    """Eq. 5 over representation vectors.  po: (B, P, F), w: (B, W, F) ->
    (B,), through the ``chamfer`` kernel (gradient to ``po`` only)."""
    return ops.chamfer(po, w, alpha)


def l2_truncated_vec(po, w):
    wt = w[..., : po.shape[-2], :]
    return ((po - wt) ** 2).sum(dim=-1).mean(dim=-1)
