"""The bf16 embedding lookup's gradient, summed in fp32 and rounded once.

JAX's transpose of ``embed.astype(ct)[tokens]`` scatter-adds the rows'
gradients in the compute dtype; over an id that a microbatch repeats
hundreds of times the bf16 sum stagnates (``scripts/
embed_grad_stagnation.py``).  The port's lookup (``transformer._rows``,
both ``_embed`` views) sums each id's gradients in fp32 and rounds the sum
once to the table's dtype.  Held here on the CPU:

- with one id 700 times among 1,024 tokens, every element of the table's
  gradient lies within one bf16 ulp of the float64 sum rounded once to
  bf16; a bf16 scatter-add (indexing a bf16 leaf) misses it by many;
- a four-way split of the sequence, each part's gradient rounded to bf16
  as a rank's is before the reduce-scatter and the parts summed, keeps
  the unsplit gradient's norm within 0.5%; the bf16 scatter-add's parts
  do not;
- the vocab-parallel view's clamped ids and masked rows give the same
  gradient, two runs give the same bits, and an fp32 table keeps
  indexing's arithmetic bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T

V, D, B, S, HOT, REPEAT = 64, 32, 4, 256, 7, 700


def _tokens_and_grad(seed=0):
    """tokens (B, S) with id HOT at REPEAT places, the others uniform, and
    an upstream gradient whose rows for one id share a sign and a scale
    (so their sum grows as the count does: the case that stagnates)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, V, B * S)
    flat[rng.choice(B * S, REPEAT, replace=False)] = HOT
    base = rng.normal(size=(V, D))
    g = base[flat] * (1.0 + 0.25 * rng.random((B * S, D)))
    return (torch.from_numpy(flat.reshape(B, S)),
            torch.from_numpy(g.reshape(B, S, D)).to(torch.bfloat16))


def _exact(tokens, g):
    """The float64 sum of each id's upstream rows (of the bf16 values)."""
    out = torch.zeros((V, D), dtype=torch.float64)
    out.index_add_(0, tokens.reshape(-1), g.double().reshape(-1, D))
    return out


def _ulps(got, want64):
    """|got - want| in units of the bf16 spacing at the rounded sum."""
    want = want64.to(torch.bfloat16)
    m, e = torch.frexp(want.double().abs().clamp_min(2.0 ** -133))
    ulp = torch.ldexp(torch.ones_like(m), e - 8)  # 8 significant bits
    return ((got.double() - want.double()).abs() / ulp).max().item()


def _lookup_grad(tokens, g, fn):
    table = torch.zeros((V, D), dtype=torch.bfloat16, requires_grad=True)
    fn(table, tokens).backward(g)
    return table.grad


def _model(dtype="bfloat16"):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              vocab=V, d_model=D, param_dtype=dtype,
                              compute_dtype=dtype)
    model = T.init_lm(cfg, seed=0, device="cpu")
    model.embed.requires_grad_(True)
    return cfg, model


def test_bf16_gradient_within_one_ulp_of_the_exact_sum():
    tokens, g = _tokens_and_grad()
    cfg, model = _model()
    T._embed(model, cfg, tokens).backward(g)
    exact = _exact(tokens, g)
    assert _ulps(model.embed.grad, exact) <= 1.0
    # A bf16 scatter-add (JAX's transpose, indexing a bf16 leaf) stagnates.
    old = _lookup_grad(tokens, g, lambda t, i: t[i])
    assert _ulps(old, exact) > 8.0


def test_four_way_split_keeps_the_unsplit_norm():
    """Each part's gradient rounded to bf16 (a rank's, before the
    reduce-scatter), then the four summed: the norm within 0.5% of the
    unsplit gradient's."""
    tokens, g = _tokens_and_grad(1)

    def split_sum(fn):
        parts = [_lookup_grad(tokens[:, i::4], g[:, i::4], fn)
                 for i in range(4)]
        return torch.stack(parts).float().sum(0)

    def share(fn):
        whole = _lookup_grad(tokens, g, fn).float()
        return abs(float(torch.linalg.vector_norm(split_sum(fn)))
                   / float(torch.linalg.vector_norm(whole)) - 1.0)

    assert share(T._rows) <= 5e-3
    assert share(lambda t, i: t[i]) > 5e-3


def test_vocab_parallel_view_and_bits():
    """The vocab-parallel view's lookup (ids clamped into the rank's
    range, others' rows masked) sums the same way; two runs give the same
    bits."""
    tokens, g = _tokens_and_grad(2)
    lo, n = 16, 32

    def view(table, ids):
        local = ids - lo
        mine = (local >= 0) & (local < n)
        rows = T._rows(table[lo:lo + n], local.clamp(0, n - 1))
        return torch.where(mine[..., None], rows, rows.new_zeros(()))

    got = _lookup_grad(tokens, g, view)
    exact = _exact(tokens, g)
    exact[:lo] = 0
    exact[lo + n:] = 0
    assert _ulps(got, exact) <= 1.0
    assert torch.equal(got, _lookup_grad(tokens, g, view))


def test_fp32_table_keeps_indexing_bits():
    tokens, g = _tokens_and_grad(3)
    cfg, model = _model("float32")
    T._embed(model, cfg, tokens).backward(g.float())
    table = model.embed.detach().clone().requires_grad_(True)
    table[tokens].backward(g.float())
    assert torch.equal(model.embed.grad, table.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_tables_sum_in_fp32(dtype):
    tokens, g = _tokens_and_grad(4)
    table = torch.zeros((V, D), dtype=dtype, requires_grad=True)
    T._rows(table, tokens).backward(g.to(dtype))
    want = torch.zeros((V, D), dtype=torch.float32).index_put_(
        (tokens.reshape(-1),), g.to(dtype).float().reshape(-1, D),
        accumulate=True).to(dtype)
    assert table.grad.dtype == dtype and torch.equal(table.grad, want)
