"""repro_torch's page allocator and run planner against repro.memory.kv_cache.

One op sequence drives both allocators: contiguous allocs, frees that
leave holes, an alloc that must fall back to scattered pages, and pool
exhaustion. Every op must give the same pages, counts and runs.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.memory import kv_cache as ref  # noqa: E402

from repro_torch.memory import kv_cache as port  # noqa: E402

OPS = [("alloc", 8), ("alloc", 8), ("alloc", 4), ("free", 1), ("alloc", 3),
       ("free", 0), ("alloc", 12), ("alloc", 10), ("free", 3), ("alloc", 20),
       ("alloc", 4), ("alloc", 1), ("free", 6), ("alloc", 9), ("alloc", 64)]


def test_allocator_matches_reference_on_one_op_sequence():
    mine, theirs = port.PageAllocator(48), ref.PageAllocator(48)
    held_mine, held_theirs = [], []
    outcomes = []
    for op, arg in OPS:
        if op == "free":
            mine.free(held_mine[arg])
            theirs.free(held_theirs[arg])
            held_mine[arg] = held_theirs[arg] = []
            outcomes.append("free")
        else:
            got = []
            for alloc, held in ((mine, held_mine), (theirs, held_theirs)):
                try:
                    pages = alloc.alloc(arg)
                except MemoryError:
                    pages = None
                held.append(pages or [])
                got.append(pages)
            assert got[0] == got[1], (op, arg)
            outcomes.append("exhausted" if got[0] is None else
                            "contiguous" if len(port.plan_page_runs(got[0])) == 1
                            else "scattered")
            if got[0] is not None:
                assert ([(r.start, r.length) for r in port.plan_page_runs(got[0])]
                        == [(r.start, r.length) for r in ref.plan_page_runs(got[1])])
        assert mine.free_count == theirs.free_count
        assert mine.fragmentation() == pytest.approx(theirs.fragmentation())
    # the sequence reaches every allocator path
    assert {"contiguous", "scattered", "exhausted"} <= set(outcomes)


def test_plan_page_runs_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(0, 40))
        pages = np.cumsum(rng.integers(0, 3, n)).tolist()   # runs, gaps, repeats
        rng.shuffle(pages[: n // 3])
        assert ([(r.start, r.length, r.stop) for r in port.plan_page_runs(pages)]
                == [(r.start, r.length, r.stop) for r in ref.plan_page_runs(pages)])


def test_allocator_rejects_double_free():
    alloc = port.PageAllocator(8)
    pages = alloc.alloc(2)
    alloc.free(pages)
    with pytest.raises(ValueError):
        alloc.free(pages)
