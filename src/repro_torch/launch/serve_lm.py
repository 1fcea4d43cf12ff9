"""Batched LM serving with the vocab embedding on tiered memory, in PyTorch
on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm          # full width
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu \\
        --reduced --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch falcon-mamba-7b                                  # or hymba-1.5b

Counterpart of ``examples/serve_lm_tiered.py``: the paper's technique
applied to an LM.  The prompt is prefilled: every attention layer through
the CUDA ``flash_attention`` kernel (in its sliding window for
``hymba-1.5b``) and every mamba layer (``falcon-mamba-7b``'s, and
``hymba-1.5b``'s beside its attention) through the CUDA ``selective_scan``
kernel; a decode step's mamba update is plain PyTorch on (B, Di, N), as
JAX leaves it to XLA.  The token-embedding table then lives
on the host tier as an fp32 copy of ``embed``, and a small device buffer
managed by the port's ``TieredEmbeddingStore`` (LRU by default) serves each
decode step's rows through the CUDA ``gather_rows_expand`` kernel.  Each
greedy step runs ``store.lookup(ids)``, casts the rows to the compute dtype
and calls ``decode_step_embeds``.  The cast is exact: the host copy holds
the rows of a table stored in that dtype, so a step sees what ``_embed``
gives for the same token.  (The JAX example feeds the store's fp32 rows
as they are, which only works at fp32: at bf16 ``decode_step_embeds``
raises there.)  As in the example, the first step feeds the prompt's last
token again.  An MoE LM is served unchanged: its prefill dispatches by
capacity, its decode steps route densely (``dense_route``).  There is no
frontend argument, as the example has none: a VLM, and the
encoder-decoder LM (``whisper-large-v3``, whose encoder reads audio
frames), are served through ``build(cfg).prefill({"tokens",
"frontend"})`` and ``.decode``.  An SSM or
hybrid LM is served unchanged too: its cache carries each layer's conv
and SSM states, and a sliding window caps the key cache at the window, a
ring that the decode wraps.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiered import TieredEmbeddingStore
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import selective_scan as _ss
from repro_torch.models.dlrm import torch_dtype
from repro_torch.models.transformer import (TransformerLM,
                                            decode_step_embeds, init_lm,
                                            prefill)

# The kernels of this path, by the name their launches are reported under.
PATH_KERNELS = (_fa.flash_attention, _ss.selective_scan,
                _eg.gather_rows_expand)
STORE_KEYS = ("batches", "lookups", "hits", "misses", "on_demand_rows",
              "evictions")


def serve_lm_tiered(cfg: ModelConfig, *, batch: int = 8,
                    prompt_len: int = 8, steps: int = 48,
                    capacity_frac: float = 0.1, policy: str = "lru",
                    device="cuda", seed: int = 0,
                    model: Optional[TransformerLM] = None,
                    prompt: Optional[np.ndarray] = None,
                    forced: Optional[np.ndarray] = None,
                    collect_logits: bool = False) -> Dict:
    """Prefill a (batch, prompt_len) prompt, then decode ``steps`` tokens
    greedily with the vocab rows served from a ``max(16, capacity_frac *
    vocab)``-row device buffer.

    ``model`` defaults to :func:`init_lm` at ``seed``; ``prompt`` to a NumPy
    draw from ``seed`` (it sets ``batch`` and ``prompt_len`` when given).
    ``forced`` (steps, batch) feeds those tokens in place of the greedy ones
    (teacher forcing, for parity tests).  Returns the store's counters and
    hit rate, ``tok_per_s`` (decode), ``prefill_ms``, ``decode_ms_p50`` (per
    step, host clock around work that ends in a device sync), each path
    kernel's ``launches`` during the call, the greedy ``tokens`` (steps,
    batch) and, with ``collect_logits``, the (steps, batch, V) fp32
    ``logits``."""
    dev = resolve_device(device)
    if model is None:
        model = init_lm(cfg, seed, dev)
    if prompt is None:
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len))
    prompt = np.asarray(prompt, np.int64)
    batch, prompt_len = prompt.shape
    ct = torch_dtype(cfg.compute_dtype)
    if dev.type == "cuda":  # load (or build) the kernels off the clock
        _fa._lib()
        _ss._lib()
        _eg._lib()
    n0 = [fn.launches for fn in PATH_KERNELS]

    synchronize(dev)
    t0 = time.perf_counter()
    _, cache = prefill(model, cfg, torch.from_numpy(prompt).to(dev),
                       cache_len=prompt_len + steps)
    synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    # Host tier: an fp32 copy of the vocab table.  Fast tier: the buffer.
    host_vocab = model.embed.detach().float().cpu().numpy()
    capacity = max(16, int(capacity_frac * cfg.vocab))
    store = TieredEmbeddingStore(host_vocab, capacity, policy=policy,
                                 device=dev)
    tok = prompt[:, -1]
    tokens, logits_out, step_ms = [], [], []
    t_dec = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        rows = store.lookup(tok)  # (batch, D) fp32 rows on the device
        logits, cache = decode_step_embeds(model, cfg, rows.to(ct)[:, None, :],
                                           cache)
        greedy = logits.argmax(dim=-1).cpu().numpy()  # ends in a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(greedy)
        if collect_logits:
            logits_out.append(logits.cpu().numpy())
        tok = greedy if forced is None else np.asarray(forced[i], np.int64)
    decode_s = time.perf_counter() - t_dec

    st = store.stats
    out = {"arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
           "steps": steps, "capacity": capacity, "policy": policy,
           "device": str(dev), **{k: getattr(st, k) for k in STORE_KEYS},
           "hit_rate": st.hit_rate,
           "tok_per_s": steps * batch / decode_s if steps else 0.0,
           "prefill_ms": prefill_ms,
           "decode_ms_p50": float(np.median(step_ms)) if steps else 0.0,
           "decode_s": decode_s,
           "launches": {fn.__name__: fn.launches - n for fn, n
                        in zip(PATH_KERNELS, n0)},
           "tokens": np.asarray(tokens).reshape(steps, batch)}
    if collect_logits:
        out["logits"] = np.stack(logits_out) if steps else None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=["smollm-135m", "smollm-360m", "qwen2.5-3b",
                             "qwen3-14b", "granite-moe-1b-a400m",
                             "falcon-mamba-7b", "hymba-1.5b"])
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small CPU-scale config (fp32)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--capacity-frac", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the fast tier run: cuda "
                         "(default; raises when CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = serve_lm_tiered(cfg, batch=args.batch, prompt_len=args.prompt_len,
                          steps=args.steps, capacity_frac=args.capacity_frac,
                          device=args.device)
    b, steps = res["batch"], res["steps"]
    print(f"{args.arch}: vocab {cfg.vocab} rows on host tier, "
          f"{res['capacity']}-row device buffer ({args.capacity_frac:.0%})")
    print(f"prefill {b} x {res['prompt_len']} tokens: "
          f"{res['prefill_ms']:.1f} ms; decode step p50 "
          f"{res['decode_ms_p50']:.2f} ms")
    print(f"decoded {steps} steps x {b} streams in {res['decode_s']:.2f}s "
          f"({res['tok_per_s']:.0f} tok/s)")
    print(f"vocab-buffer hit rate: {res['hit_rate']:.1%} "
          f"(on-demand rows: {res['on_demand_rows']})")
    print("kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in res["launches"].items()))
    print("greedy decode concentrates on hot tokens -> the buffer converges "
          "to the hot vocabulary, exactly the paper's power-law regime.")
    return res


if __name__ == "__main__":
    main()
