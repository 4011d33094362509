"""Deterministic synthetic token pipeline with restart-safe cursors.

A copy of ``repro/data/pipeline.py`` (pure numpy; the port imports nothing
of ``repro``). Batches are a pure function of (seed, step): after a crash
the pipeline resumes from the manifest's step with identical data — no
shard-state files needed. The generator mimics Zipfian token frequencies
(the paper's YCSB-Zipfian workloads) so embeddings see realistic skew, and
packs documents with −100-masked boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 256


class SyntheticTokens:
    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        # Zipfian draw, clipped into vocab
        toks = rng.zipf(c.zipf_a, size=(c.global_batch, c.seq_len + 1))
        toks = (toks - 1) % c.vocab_size
        # document packing: boundaries reset next-token supervision
        n_docs = max(1, (c.seq_len // c.mean_doc_len))
        targets = toks[:, 1:].astype(np.int32).copy()
        for b in range(c.global_batch):
            cuts = rng.integers(1, c.seq_len, size=n_docs)
            targets[b, cuts - 1] = -100         # masked at doc boundary
        return {"tokens": toks[:, :-1].astype(np.int32), "targets": targets}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
