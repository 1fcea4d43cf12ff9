"""Deterministic, resumable synthetic LM token pipeline.

Copied from ``src/repro/data/lm_data.py`` (NumPy only): the port imports
nothing of the JAX package, so it keeps its own copy; ``batch_at`` gives
the same bytes.

Fault-tolerance contract: batch(step) is a pure function of (seed, step,
shape), so restart-from-checkpoint replays the exact stream with no data
loss or duplication, and elastic restarts with a different data-parallel
layout still see the same global batch order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class LMDataConfig:
    vocab: int = 49152
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    # Markov-ish synthetic text: makes loss meaningfully decrease.
    n_states: int = 64


def _batch_np(cfg: LMDataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    B, S = cfg.global_batch, cfg.seq_len
    # Low-order Markov structure so a real LM can learn something.
    trans = np.arange(cfg.n_states)
    state = rng.integers(0, cfg.n_states, size=B)
    toks = np.empty((B, S), dtype=np.int32)
    noise = rng.integers(0, cfg.vocab, size=(B, S))
    jump = rng.random((B, S)) < 0.15
    for t in range(S):
        state = (state * 31 + 17) % cfg.n_states
        toks[:, t] = state * (cfg.vocab // cfg.n_states)
    toks = np.where(jump, noise, toks).astype(np.int32)
    return toks % cfg.vocab


def batch_at(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    toks = _batch_np(cfg, step)
    labels = np.concatenate(
        [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], axis=1
    )
    return {"tokens": toks, "labels": labels}


def stream(cfg: LMDataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
