"""Faults planted in the program under test, to see that the check catches
each one a cell can have. Used by the CPU tests (``bench/tests``) and, at a
cell's own size on the chip, by ``bench/tools/control.py --fault NAME``.

- ``token_altered``: every row's best logit handed to the next token id,
  where the program produces it (``Transformer.decode_step`` and
  ``Transformer.prefill``);
- ``decode_state_unchanged``: a decode step that leaves its cache as it
  found it;
- ``train_state_unchanged``: a train step whose optimizer leaves the
  parameters and its state as they were;
- ``half_batch``: a train step whose loss is the mean over the first half
  of the batch's rows only.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def token_altered():
    from repro_torch.models import transformer
    cls = transformer.Transformer

    def wrap(orig):
        def altered(self, *a, **k):
            logits = orig(self, *a, **k)
            V = self.cfg.vocab_size
            flat = logits.reshape(-1, logits.shape[-1])
            wrong = (flat[:, :V].argmax(-1) + 1) % V
            flat[torch.arange(flat.shape[0], device=flat.device), wrong] += 1e3
            return logits
        return altered

    with mock.patch.object(cls, "decode_step", wrap(cls.decode_step)), \
            mock.patch.object(cls, "prefill", wrap(cls.prefill)):
        yield


@contextlib.contextmanager
def decode_state_unchanged():
    from repro_torch.models import transformer
    orig = transformer.Transformer.decode_step

    def frozen(self, cache, *a, **k):
        saved = {n: t.clone() for n, t in transformer.cache_tensors(cache).items()}
        logits = orig(self, cache, *a, **k)
        for n, t in transformer.cache_tensors(cache).items():
            t.copy_(saved[n])
        return logits

    with mock.patch.object(transformer.Transformer, "decode_step", frozen):
        yield


@contextlib.contextmanager
def train_state_unchanged():
    from repro_torch.optim import adamw

    def no_update(grads, state, params, run, **k):
        return state, {"lr": 0.0, "grad_norm": torch.zeros(())}

    with mock.patch.object(adamw, "update", no_update):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.launch import steps
    orig = steps.loss_fn

    def half(model, tokens, targets, **k):
        n = tokens.shape[0] // 2
        return orig(model, tokens[:n], targets[:n], **k)

    with mock.patch.object(steps, "loss_fn", half):
        yield


FAULTS = {f.__name__: f for f in (token_altered, decode_state_unchanged,
                                  train_state_unchanged, half_batch)}
