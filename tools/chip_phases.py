#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card: the device line,
the kernels' build, then each phase named that needs no other phase's
output (those taking no argument, only the card's ``nvidia-smi`` line, or
only the device).

    python3 tools/chip_phases.py steps [model examples ...]
    python3 tools/chip_phases.py --rounds 2 serve serve_archs hybrid_decode

``--rounds N`` runs the phases named N times in turn and prints each
phase's seconds of every round.

A quick check of one phase after a change to what it drives; the whole
script stays the proof that every phase passes.
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv: list) -> None:
    rounds = 1
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    smi = cs.phase_device()
    cs.timed("build", cs.phase_build)
    given = {"smi": smi, "dev": cs.torch.device("cuda", 0)}
    seconds: dict = {}
    for _ in range(rounds):
        for name in argv:
            fn = getattr(cs, f"phase_{name}", None)
            if fn is None:
                raise SystemExit(f"chip_smoke.py has no phase {name!r}")
            params = list(inspect.signature(fn).parameters)
            if not set(params) <= set(given):
                raise SystemExit(f"phase {name!r} needs another phase's output: {params}")
            cs.timed(name, fn, *(given[p] for p in params))
            seconds.setdefault(name, []).append(cs.PHASE_SECONDS[name])
            cs.torch.cuda.empty_cache()
    cs.emit({"phase_seconds": seconds})


if __name__ == "__main__":
    main(sys.argv[1:])
