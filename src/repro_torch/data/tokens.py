"""Synthetic LM token pipeline for the train driver.

Port of `repro/data/tokens.py`. The stream is host-side numpy, copied as
it is, so a batch is bitwise the reference's; the caller uploads it.
`regression_shards_to_device` featurizes a per-agent `Dataset` on torch
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov-ish structure so the loss actually decreases during smoke training
    structure: float = 0.8


class TokenStream:
    """Infinite deterministic stream of (tokens, labels) batches.

    Generates order-1 structured sequences: with prob `structure` the next
    token is (prev * 31 + 7) % vocab (learnable), else uniform noise.
    """

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        det = (rng.random((B, S)) < cfg.structure)
        noise = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1].astype(np.int64) * 31 + 7) % V
            toks[:, t] = np.where(det[:, t], nxt, noise[:, t]).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return toks, labels

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def regression_shards_to_device(dataset, rff_params, featurize_fn, *,
                                device: torch.device | str | None = None):
    """Featurize a per-agent `Dataset` into (N, T, D) tensors ready for the
    COKE Problem, on `device` (None means "cuda")."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    feats = featurize_fn(rff_params, torch.as_tensor(dataset.x, device=dev))
    labels = torch.as_tensor(dataset.y, device=dev)
    return feats, labels
