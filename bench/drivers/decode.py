"""Decode sessions: a closed loop of B sessions decoding together, greedy.

Set-up: the seed's weights into the program's ``Transformer``, its decode
cache (``init_cache(B, capacity)``), one (B, prefill_tokens) prefill that
writes every session's history, then ``warmup_steps`` decode steps (the
first tokens of the first turns, served and checked like the rest).

Each session's history length is drawn from the mix's ``history`` spec
(``bench.lib.program.lengths``: stratified over the B sessions); a turn
starts with one new token drawn from the seed at the end of the history
and runs greedy steps, as many as the next length of a stream drawn from
``turn_tokens`` (stratified in blocks of B; null: one turn all through the
window). When a turn ends, the session's position goes back to its
history, its pages are kept, and the next turn starts.

Window: decode steps until ``--seconds`` have passed on the host clock.
``out_tokens`` counts every token served in it; ``itl_ms`` holds the gap
before each token that continues a turn, from CUDA events recorded after
each step. The check runs the reference over a sample of the turns that
ended in the window (the longest among them), or, with one turn a
session, over the sampled sessions' tokens so far.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from bench.lib import program
from bench.lib.harness import measure, release, sync

TURNS = 4096            # turns drawn for a run, far more than a window ends


class Sessions:
    """Host-side state of the B sessions: positions, turns, and each turn's record."""

    def __init__(self, traffic: dict, rng: np.random.Generator) -> None:
        B = traffic["sessions"]
        self.hist = program.lengths(traffic["history"], B, rng)
        self.B = B
        turns = traffic.get("turn_tokens")
        self.turn_len = None if turns is None else program.lengths(
            turns, TURNS, rng, block=B)
        self.taken = 0
        self.rng = rng
        self.pos = self.hist.copy()                     # position the next fed token takes
        self.left = np.array([self._next_len() for _ in range(B)])
        self.turns: List[dict] = []                     # finished and open turns
        self.open = [None] * B

    def _next_len(self) -> int:
        if self.turn_len is None:
            return np.iinfo(np.int64).max
        if self.taken == len(self.turn_len):
            raise RuntimeError("the window outran the turns drawn")
        self.taken += 1
        return int(self.turn_len[self.taken - 1])

    def first_tokens(self, step: int, vocab: int, sessions) -> np.ndarray:
        toks = self.rng.integers(0, vocab, len(sessions))
        for b, t in zip(sessions, toks):
            self.open[b] = {"b": int(b), "h": int(self.pos[b]), "first": int(t),
                            "start": step, "n": 0, "end": None}
            self.turns.append(self.open[b])
        return toks

    def advance(self, step: int) -> List[int]:
        """After a step: every session has served one more token; returns the
        sessions whose turn ended (they start a new one next step)."""
        self.pos += 1
        self.left -= 1
        ended = []
        for b in range(self.B):
            self.open[b]["n"] += 1
            if self.left[b] == 0:
                self.open[b]["end"] = step
                self.pos[b] = self.hist[b]
                self.left[b] = self._next_len()
                ended.append(b)
        return ended


def run(r) -> None:
    t, m, dev = r.traffic, r.model, r.device
    V = m["vocab_size"]
    rng = program.seeded(r.seed, 0)
    w = program.weights(r)
    _, model = program.build(r, w)
    B, P = t["sessions"], t["prefill_tokens"]
    prompts = rng.integers(0, V, (B, P))
    sess = Sessions(t, rng)
    if (sess.hist > P).any():
        raise ValueError("a history is longer than the prefill that writes it")
    with torch.no_grad():
        cache = model.init_cache(B, t["capacity"], page_tokens=t.get("page_tokens", 16),
                                 pages_per_block=t.get("pages_per_block", 4))
        model.prefill(torch.from_numpy(prompts).to(dev), cache)
        tok = torch.from_numpy(sess.first_tokens(0, V, range(B))).to(dev)
        fed, out, lengths = [], [], []
        marks = program.Marks(dev)
        step = 0

        def one_step() -> None:
            nonlocal tok, step
            fed.append(tok)
            lengths.append(sess.pos + 1)
            with record_function("bench.decode_step"):
                logits = model.decode_step(cache, tok, sess.pos.copy())
            with record_function("bench.argmax"):
                nxt = logits[:, :V].argmax(dim=-1)
            marks.mark()
            out.append(nxt)
            ended = sess.advance(step)
            step += 1
            tok = nxt
            if ended:
                tok = nxt.clone()
                tok[ended] = torch.from_numpy(sess.first_tokens(step, V, ended)).to(dev)

        for _ in range(t["warmup_steps"]):
            one_step()
        sync(dev)
        first = step                   # the window's first step; step k's mark is marks[k]
        measure(r, one_step, lengths, t["trace_steps"], t["trace_host_steps"])
        last = step
        fed_h = torch.stack(fed).cpu().numpy()         # (steps, B)
        out_h = torch.stack(out).cpu().numpy()
    starts = {(tn["b"], tn["start"]) for tn in sess.turns}
    itl = []
    for k in range(first, last):
        itl += [marks.ms_between(k - 1, k)] * sum((b, k) not in starts for b in range(B))
    r.samples["itl_ms"] = itl
    steps_ms = [marks.ms_between(k - 1, k) for k in range(first, last)]
    tenth = max(1, len(steps_ms) // 10)
    r.notes["step_ms_median_by_tenth"] = [
        float(np.median(steps_ms[i:i + tenth])) for i in range(0, len(steps_ms), tenth)][:10]
    r.counts["out_tokens"] = B * (last - first)
    active = [tn for tn in sess.turns if tn["end"] is None or tn["end"] >= first]
    r.counts["attempted"] = len(active)
    r.counts["failed"] = 0
    r.notes["window_steps"] = last - first
    del model, cache, tok, fed, out
    release(dev)
    _check(r, w, prompts, sess, fed_h, out_h, first, last)


def _check(r, w, prompts, sess: Sessions, fed, out, first: int, last: int) -> None:
    """The widest gap by which a served token's logit lies below the
    reference's best, over a sample of turns (the longest among them)."""
    t = r.traffic
    done = [tn for tn in sess.turns if tn["end"] is not None and first <= tn["end"] < last]
    r.notes["turns_finished"] = len(done)
    if not done:                  # no turn ended in the window: the open turns' tokens so far
        done = [tn for tn in sess.turns if tn["end"] is None and tn["n"] > 0]
    if not done:
        r.readings["served_gap"] = float("nan")
        return
    rng = program.seeded(r.seed, 1)
    longest = max(range(len(done)), key=lambda i: done[i]["n"])
    rest = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.permutation(rest)[: t["check_turns"] - 1])
    seqs, rows, served = [], [], []
    for i in pick:
        tn = done[i]
        b, h, s0, n = tn["b"], tn["h"], tn["start"], tn["n"]
        seqs.append(np.concatenate([prompts[b, :h], fed[s0:s0 + n, b]]))
        rows.append(list(range(h, h + n)))
        served.append(out[s0:s0 + n, b])
    S = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), S), np.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    ref = r.reference
    logits = ref.logits_at(w.group, r.model, torch.from_numpy(toks).to(r.device), rows)
    gap = max(float(ref.gaps(lg, torch.from_numpy(sv).to(r.device)).max())
              for lg, sv in zip(logits, served))
    r.readings["served_gap"] = gap
    r.notes["checked_tokens"] = int(sum(len(x) for x in served))
    if r.control:                  # the reference in lower precision, in the program's place
        low = ref.logits_at(w.group, r.model, torch.from_numpy(toks).to(r.device), rows,
                            quant=r.control)
        r.notes["control"] = {"served_gap": max(
            float(ref.gaps(lg, lo.argmax(-1)).max()) for lg, lo in zip(logits, low))}
