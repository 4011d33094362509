"""The program under test, as the drivers meet it: a ``repro_torch``
``Transformer`` built from a configuration file's sizes, its parameters
filled with the benchmark's own draws (``bench.lib.weights``)."""

from __future__ import annotations

import math
import time
from statistics import NormalDist
from typing import List, Optional

import numpy as np
import torch

from bench.lib.weights import Weights


def weights(run) -> Weights:
    ref = run.reference
    return Weights(ref.groups(run.model), ref.full_name, run.seed, run.device)


def build(run, w: Weights):
    """(program config, model) with the seed's weights."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Transformer
    cfg = ModelConfig(**run.model)
    model = Transformer(cfg, device="meta").to_empty(device=run.device)
    w.fill(dict(model.named_parameters()))
    return cfg, model


def lengths(spec, n: int, rng: np.random.Generator, block: Optional[int] = None) -> np.ndarray:
    """n lengths drawn from the seed by a mix's ``spec``: a whole number (every
    length that), or a log-normal ({"median", "sigma"}) truncated to its
    ``range`` and rounded to a multiple of ``multiple``. Draws are stratified
    in blocks of ``block`` (default n): each block takes one draw from each
    of its equal-probability strata, in the seed's order, so every seed meets
    the same distribution, tail included, and only the order and the draws
    within each stratum change."""
    if isinstance(spec, (int, np.integer)):
        return np.full(n, int(spec), np.int64)
    lo, hi = spec["range"]
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    unit = NormalDist()
    a, b = unit.cdf((math.log(lo) - mu) / sigma), unit.cdf((math.log(hi) - mu) / sigma)
    k = block or n
    u = np.concatenate([(rng.permutation(k) + rng.random(k)) / k
                        for _ in range(-(-n // k))])[:n]
    p = np.clip(a + (b - a) * u, 1e-12, 1 - 1e-12)
    x = np.exp(mu + sigma * np.array([unit.inv_cdf(float(q)) for q in p]))
    m = spec.get("multiple", 1)
    return np.clip(np.round(x / m) * m, lo, hi).astype(np.int64)


class Marks:
    """Timestamps of the device stream's progress: a CUDA event recorded after
    each unit of work (the host clock on the CPU, which only the tests use)."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        self.events: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())

    def ms_between(self, i: int, j: int) -> float:
        a, b = self.events[i], self.events[j]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def seeded(seed: int, tag: int, device: Optional[torch.device] = None):
    """A host (numpy) or device (torch) generator for one stream of the run."""
    if device is None:
        return np.random.default_rng([seed & ((1 << 64) - 1), tag])
    from bench.lib.weights import group_seed
    return torch.Generator(device=device).manual_seed(group_seed(seed, 1_000_000 + tag))
