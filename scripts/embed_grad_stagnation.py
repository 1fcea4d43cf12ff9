"""How much of the embedding's gradient a bf16 scatter-add keeps over the
training batches' repeated token ids, against the fp32 sum.

    PYTHONPATH=src python scripts/embed_grad_stagnation.py [--device cpu]

The lookup's backward (``transformer._embed``'s ``table[tokens]`` under
autograd) adds one row a token into the table's gradient in the table's
dtype.  ``batch_at``'s microbatch of qwen2.5-3b's training cut (4 rows x
2,048 tokens of a 151,936-id vocab) repeats ids hundreds of times, and a
bf16 running sum stops growing once a row's increments fall under its
last bit.  Each token's row here is its id's fixed random direction plus
0.3 of noise (a token's gradient rows are alike, which is what makes the
sum grow); the script sums them in fp32, in bf16 over the whole
microbatch, and in bf16 over the parts a sequence split gives (2 and 4
parts of the (data, model) blocks, summed in bf16 afterwards), and prints
each sum's norm and its error norm as shares of the fp32 sum's, with the
microbatch's distinct ids and largest repeat count.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.data.lm_data import LMDataConfig, batch_at

VOCAB, SEQ, ROWS, WIDTH = 151936, 2048, 4, 64


def scatter_sum(tokens, rows, dtype):
    out = torch.zeros((VOCAB, WIDTH), dtype=dtype, device=rows.device)
    return out.index_put_((tokens.reshape(-1),),
                          rows.reshape(-1, WIDTH).to(dtype), accumulate=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    batch = batch_at(LMDataConfig(vocab=VOCAB, seq_len=SEQ,
                                  global_batch=2 * ROWS), 0)
    tokens = torch.from_numpy(np.asarray(batch["tokens"])[:ROWS]).long() \
        .to(args.device)
    g = torch.Generator().manual_seed(0)
    base = torch.randn(VOCAB, WIDTH, generator=g)
    rows = ((base[tokens.cpu().reshape(-1)] + 0.3 * torch.randn(
        tokens.numel(), WIDTH, generator=g)) * 1e-3).to(args.device)
    exact = scatter_sum(tokens, rows, torch.float32)
    blocks = tokens.view(2, ROWS // 2, SEQ), rows.view(2, ROWS // 2, SEQ,
                                                       WIDTH)
    sums = {"bf16_whole": scatter_sum(tokens, rows, torch.bfloat16)}
    for parts in (2, 4):
        n_model = parts // 2
        step = SEQ // n_model
        acc = None
        for d in range(2):
            for m in range(n_model):
                sl = slice(m * step, (m + 1) * step)
                part = scatter_sum(blocks[0][d][:, sl], blocks[1][d][:, sl],
                                   torch.bfloat16)
                acc = part if acc is None else acc + part
        sums[f"bf16_{parts}_parts"] = acc
    _, counts = np.unique(tokens.cpu().numpy(), return_counts=True)
    norm = float(exact.norm())
    print(json.dumps({
        "tokens": tokens.numel(), "distinct_ids": int(len(counts)),
        "largest_repeat": int(counts.max()), "fp32_norm": norm,
        **{k: {"norm_share": float(v.float().norm()) / norm,
               "error_share": float((v.float() - exact).norm()) / norm}
           for k, v in sums.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
