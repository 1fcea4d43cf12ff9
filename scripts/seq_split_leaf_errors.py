"""Where a bf16 sequence-split training step departs from one rank, leaf
by leaf, on one card.

    python scripts/seq_split_leaf_errors.py

Trains ``chip_smoke.py``'s qwen2.5-3b cut (2 of 36 layers, bf16, S =
2,048, a global batch of 8 in 2 microbatches, remat full) two steps on
one rank and saves its first-step gradients and final parameters; then
four ``gloo`` ranks on the card train the same steps on a (2, 2) mesh
under ``fsdp_seq`` inside ``activation_sharding(mesh, "fsdp_seq")`` (the
sequence split) and under ``fsdp_tp``, and each rank prints, for both,
its losses, the six leaves whose first-step gradient shard is farthest
from the one rank's (largest error over the leaf's largest magnitude,
``chip_smoke._leaf_errors``) and the four whose parameters after step 2
are farthest as a share of the update.  Before them it checks the offset
backward at the split's two ranks' shapes, (2, 1,024, 16/2, 128) bf16 at
offsets 0 and 1,024 against 2,048 keys: 30 calls bit-equal and its error
against ``flash_attention_bwd_ref``.  Prints JSON lines.  Needs one card
and nvcc.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from chip_smoke import ST, M, fa, ref  # noqa: E402


def kernel_check() -> dict:
    out = {}
    for off in (0, 1024):
        g = torch.Generator(device="cuda").manual_seed(3)
        q, do = (torch.randn((2, 1024, 16, 128), generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((2, 2048, 2, 128), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, with_lse=True, q_offset=off)
        first = fa.flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
        same = all(all(torch.equal(a, b) for a, b in zip(
            first, fa.flash_attention_bwd(q, k, v, o, do, lse,
                                          q_offset=off)))
            for _ in range(30))
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, 0, True, off)
        out[off] = {"bit_equal_30_calls": same, "max_share": {
            n: float((a.float() - w.float()).abs().max()
                     / w.float().abs().max())
            for n, a, w in zip(("dq", "dk", "dv"), first, want)}}
    return out


def rank_main(rank, world, work):
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = M.init_distributed("gloo", f"file://{work}/store", rank, world,
                             device="cuda:0", timeout=300)
    cfg = CS.st_cfg(ST["arch"])
    mesh = M.make_mesh(*ST["mesh"])
    rec = {}
    for sharding in ("fsdp_seq", "fsdp_tp"):
        bundle, model, opt, step, data = CS.st_trainer(
            cfg, ST["seq"], mesh, dev, sharding=sharding)
        with M.activation_sharding(mesh, sharding):
            losses, errs, _, uerrs = CS.st_parity_steps(
                bundle, model, opt, step, data, mesh, Path(work, "qwen"))
        rec[sharding] = {
            "losses": losses,
            "grad_err_top": sorted(errs.items(), key=lambda kv: -kv[1])[:6],
            "update_err_top": sorted(uerrs.items(),
                                     key=lambda kv: -kv[1])[:4]}
        del model, opt, step, bundle
        torch.cuda.empty_cache()
    Path(work, f"rank{rank}.json").write_text(json.dumps(rec))
    M.close_distributed()


def main() -> int:
    print(json.dumps({"kernel": kernel_check()}), flush=True)
    work = tempfile.mkdtemp(prefix="seq_split_leaf_errors_")
    bundle, model, opt, step, data = CS.st_trainer(CS.st_cfg(ST["arch"]),
                                                   ST["seq"])
    losses = CS.st_parity_steps(bundle, model, opt, step, data, None,
                                Path(work, "qwen"))
    grads = torch.load(Path(work, "qwen_grads.pt"))
    print(json.dumps({"one_rank_losses": losses, "largest_grad_norms": sorted(
        ((n, float(g.float().norm())) for n, g in grads.items()),
        key=lambda kv: -kv[1])[:6]}), flush=True)
    del model, opt, step, bundle, grads
    torch.cuda.empty_cache()
    torch.multiprocessing.spawn(rank_main, args=(4, work), nprocs=4,
                                join=True)
    for r in range(4):
        print(json.dumps({"rank": r, **json.loads(
            Path(work, f"rank{r}.json").read_text())}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
