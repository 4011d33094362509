"""Prefill requests: a closed loop of one request at a time, one output token.

Set-up: the seed's weights into the program's ``Transformer`` and one
decode cache of the longest prompt the mix allows, which every request's prefill writes
(a server keeps its pool), then one prefill at each prompt length the run
uses. Prompt lengths are drawn from the mix's ``lengths`` spec
(``bench.lib.program.lengths``, stratified in blocks of ``block``
requests), tokens drawn from the seed.

Window: requests until ``--seconds`` have passed on the host clock. A
request is the prompt's copy to the device, ``Transformer.prefill``, the
greedy token on the device and its copy back; ``ttft_ms`` is its time
from CUDA events recorded before the copy and after the argmax. The check
runs the reference over a sample of the requests (the longest among
them) and compares the served token and the last-position logits.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from bench.lib import program
from bench.lib.harness import measure, release, sync

def run(r) -> None:
    t, m, dev = r.traffic, r.model, r.device
    V = m["vocab_size"]
    rng = program.seeded(r.seed, 0)
    w = program.weights(r)
    _, model = program.build(r, w)
    order = program.lengths(t["lengths"], t["max_requests"], rng, block=t["block"])
    sizes = np.unique(order)
    prompts = [rng.integers(0, V, n) for n in order]
    kept = torch.empty((t["max_requests"], V), dtype=torch.bfloat16, device=dev)
    served = []
    lengths = []
    with torch.no_grad():
        longest = int(t["lengths"]["range"][1])
        cache = model.init_cache(1, longest, page_tokens=t.get("page_tokens", 16),
                                 pages_per_block=t.get("pages_per_block", 4))
        marks = program.Marks(dev)

        def request(tokens: np.ndarray, keep: int = -1) -> int:
            marks.mark()
            with record_function("bench.prefill"):
                x = torch.from_numpy(tokens[None]).to(dev)
                logits = model.prefill(x, cache)[0, :V]
            with record_function("bench.argmax"):
                tok = logits.argmax()
            marks.mark()
            if keep >= 0:
                kept[keep] = logits
            return int(tok)

        for n in sizes:                                 # every length the mix uses
            request(rng.integers(0, V, n))
        sync(dev)
        marks.events.clear()
        i = 0

        def next_request() -> None:
            nonlocal i
            if i >= len(prompts):
                raise RuntimeError("the window outran max_requests")
            lengths.append(len(prompts[i]))
            served.append(request(prompts[i], keep=i))
            i += 1

        measure(r, next_request, lengths, t["trace_requests"], t["trace_host_requests"])
    r.samples["ttft_ms"] = [marks.ms_between(2 * k, 2 * k + 1) for k in range(i)]
    r.counts.update(attempted=i, failed=0)
    r.notes["requests"] = i
    logits_h = kept[:i].float().cpu()
    del model, cache, kept
    release(dev)
    _check(r, w, prompts[:i], np.array(served), logits_h)


def _check(r, w, prompts, served: np.ndarray, logits: torch.Tensor) -> None:
    """Over a sample of requests (the longest among them): the widest gap by
    which a served token's logit lies below the reference's best, and the
    largest |program − reference| of a last-position logit over the
    reference's largest |logit|."""
    t = r.traffic
    rng = program.seeded(r.seed, 1)
    longest = int(np.argmax([len(p) for p in prompts]))
    rest = [k for k in range(len(prompts)) if k != longest]
    pick = [longest] + [int(k) for k in rng.permutation(rest)[: t["check_requests"] - 1]]
    S = max(len(prompts[k]) for k in pick)
    toks = np.zeros((len(pick), S), np.int64)
    for j, k in enumerate(pick):
        toks[j, :len(prompts[k])] = prompts[k]
    ref = r.reference
    rows = [[len(prompts[k]) - 1] for k in pick]
    out = ref.logits_at(w.group, r.model, torch.from_numpy(toks).to(r.device), rows)
    gap, err = 0.0, 0.0
    for j, k in enumerate(pick):
        lg = out[j][0]
        gap = max(gap, float(ref.gaps(lg[None], torch.tensor([served[k]], device=lg.device))[0]))
        prog = logits[k].to(lg.device)
        err = max(err, float((prog - lg).abs().max() / lg.abs().max()))
    r.readings["served_gap"] = gap
    r.readings["logit_err"] = err
    r.notes["checked_requests"] = len(pick)
    if r.control:                  # the reference in lower precision, in the program's place
        low = ref.logits_at(w.group, r.model, torch.from_numpy(toks).to(r.device), rows,
                            quant=r.control)
        r.notes["control"] = {
            "served_gap": max(float(ref.gaps(lg, lo.argmax(-1))[0]) for lg, lo in zip(out, low)),
            "logit_err": max(float((lo - lg).abs().max() / lg.abs().max())
                             for lg, lo in zip(out, low))}
