"""Decode steps replayed as CUDA graphs (``repro_torch.models.decode_graph``).

On the CPU:

- ``plan_step`` of the paged pool, the ring and MLA's latent cache returns
  the values it returned when it made fresh tensors each step, in tensors at
  the same addresses step after step; the paged pool plans its blocks once,
  when it is made, and its page table refuses writes;
- ``eager_reason`` over every arch of the registry: on the CPU only the
  device keeps a step eager; a sharded cache part, parameters that autograd
  records, and a mesh (``test_torch_sharding.py``) are named first;
- ``launch.serve`` prints the decode steps' counts after its decode;
- the counts of ``DecodeGraphs.snapshot()`` add up, and the bookkeeping of
  warm-up, captures by key, replays and the kernels' launch counts holds,
  with the CUDA calls stood in for by fakes that record what they are asked.

On the card (skipped here): graph-replayed logits equal the eager body's bit
for bit over 48 steps of a small paged model that crosses several
``live_blocks`` keys and a turn reset, and over a ring + SSM hybrid through
the ring's wrap (the reduced hymba's through the ring kernel); every arch of
the registry replays its decode bit for bit; a returned logits tensor is not
changed by the next step. This file imports no JAX, so on a card

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_decode_graph.py
"""

import ast
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch.configs import ARCH_IDS, ModelConfig, get_reduced  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.ring_attention import ops as ra  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (count_live_blocks,  # noqa: E402
                                                     plan_blocks)
from repro_torch.models import (HybridCache, PagedKVPool, RingKVCache,  # noqa: E402
                                init_transformer)
from repro_torch.models import decode_graph as dg  # noqa: E402
from repro_torch.models.mla import LatentCache  # noqa: E402
from repro_torch.models.transformer import _parts  # noqa: E402

DENSE = ModelConfig(name="graph-dense", family="dense", num_layers=2, d_model=64,
                    vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128)
HYBRID = ModelConfig(name="graph-hybrid", family="hybrid", num_layers=2, d_model=64,
                     vocab_size=128, mixer="hybrid", num_heads=4, num_kv_heads=2,
                     head_dim=32, window=16, d_ff=128, ssm_state=8, ssm_heads=2,
                     ssm_head_dim=32, ssm_chunk=8)
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# plans at fixed addresses
# ---------------------------------------------------------------------------

def _old_paged_plan(pool, cur):
    """The pool's plan as it was made before it had a buffer: fresh tensors."""
    starts, valid = plan_blocks(pool.page_table, pool.pages_per_block)
    return (starts, valid, (cur + 1).astype(np.int32),
            pool.token_slots(cur[:, None])[:, 0].astype(np.int32),
            count_live_blocks(valid, cur + 1, pool.page_tokens))


def _old_slot_plan(cache, cur):
    slot = cur % cache.length
    age = (slot[:, None] - np.arange(cache.length)[None, :]) % cache.length
    return cur[:, None], slot, age < np.minimum(cur + 1, cache.length)[:, None]


def _addresses(*tensors):
    return [t.data_ptr() for t in tensors]


def test_paged_plan_keeps_its_values_at_fixed_addresses():
    pool = PagedKVPool(DENSE, 3, 96, page_tokens=4, pages_per_block=4, device=CPU)
    rng = np.random.default_rng(0)
    seen = None
    for _ in range(6):
        cur = rng.integers(0, 96, 3)
        plan = pool.plan_step(cur)
        starts, valid, lengths, slot, live = _old_paged_plan(pool, cur)
        np.testing.assert_array_equal(plan.block_start.numpy(), starts)
        np.testing.assert_array_equal(plan.block_valid.numpy(), valid)
        np.testing.assert_array_equal(plan.lengths.numpy(), lengths)
        np.testing.assert_array_equal(plan.slot.numpy(), slot)
        np.testing.assert_array_equal(plan.positions.numpy(), cur[:, None])
        assert plan.live_blocks == plan.launch_keys[0] == live
        assert all(t.dtype == torch.int32 for t in (plan.block_start, plan.block_valid,
                                                    plan.lengths, plan.slot))
        got = _addresses(plan.block_start, plan.block_valid, plan.lengths, plan.slot)
        assert seen is None or got == seen
        seen = got


def test_paged_pool_plans_its_blocks_once(monkeypatch):
    """The blocks follow from the page table alone, fixed when the pool is
    made: the six steps above plan none, and keep the values and addresses."""
    from repro_torch.models import attention

    calls = []
    monkeypatch.setattr(attention, "plan_blocks",
                        lambda *args: calls.append(args) or plan_blocks(*args))
    test_paged_plan_keeps_its_values_at_fixed_addresses()
    assert len(calls) == 1


def test_paged_pool_page_table_refuses_writes():
    """A table written after the blocks were planned would decode stale blocks."""
    pool = PagedKVPool(DENSE, 2, 32, page_tokens=4, device=CPU)
    with pytest.raises(ValueError, match="read-only"):
        pool.page_table[0, 0] = pool.page_table[1, 0]


@pytest.mark.parametrize("kind", ["ring", "latent"])
def test_slot_plan_keeps_its_values_at_fixed_addresses(kind):
    if kind == "ring":
        cache = RingKVCache(HYBRID, 3, 200, device=CPU)         # a ring of 16 slots
        high = 200
    else:
        cfg = get_reduced("deepseek-v2-lite-16b")
        cache = LatentCache(cfg, 3, 40, device=CPU)
        high = 40
    rng = np.random.default_rng(1)
    seen = None
    for step in range(6):
        cur = rng.integers(0, high, 3) if step else np.array([0, 5, high - 1])
        plan = cache.plan_step(cur)
        positions, slot, valid = _old_slot_plan(cache, cur)
        assert plan.positions.dtype == plan.slot.dtype == torch.int64
        assert plan.valid.dtype == torch.bool and plan.launch_keys == (None,)
        np.testing.assert_array_equal(plan.positions.numpy(), positions)
        np.testing.assert_array_equal(plan.slot.numpy(), slot)
        np.testing.assert_array_equal(plan.valid.numpy(), valid)
        got = _addresses(plan.positions, plan.slot, plan.valid)
        assert seen is None or got == seen
        seen = got


def test_slot_plan_takes_a_strided_position_array():
    """Positions sliced out of a (steps, B) table are not contiguous."""
    cache = RingKVCache(HYBRID, 2, 200, device=CPU)
    table = np.array([[3, 40], [4, 41]])
    plan = cache.plan_step(table[:, 1])
    np.testing.assert_array_equal(plan.positions.numpy(), [[40], [41]])
    np.testing.assert_array_equal(plan.slot.numpy(), [40 % 16, 41 % 16])


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def _decoder(cfg, batch=2, max_len=40):
    model = init_transformer(cfg, seed=0, device="cpu")
    return model, model.init_cache(batch, max_len, page_tokens=4)


def _token(cfg, batch=2):
    if cfg.frontend:
        return torch.zeros(batch, cfg.d_model, dtype=torch.bfloat16)
    return torch.zeros(batch, dtype=torch.long)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_only_the_device_keeps_an_unsharded_step_eager(arch):
    """Every arch's cache (paged, ring, latent, SSM, hybrid; MoE and MLA
    blocks) meets the rule: on the CPU the device is the one reason."""
    cfg = get_reduced(arch)
    model, cache = _decoder(cfg)
    with torch.no_grad():
        for t in range(3):
            model.decode_step(cache, _token(cfg), np.full(2, t))
    assert dg.eager_reason(model, _parts(cache)) == "cpu device"
    assert model.decode_graphs(cache).snapshot() == {
        "replays": 0, "captures": {}, "eager": {"cpu device": 3}}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b", "deepseek-v2-lite-16b",
                                  "mamba2-780m"])
def test_a_sharded_cache_part_keeps_the_step_eager(arch):
    model, cache = _decoder(get_reduced(arch))
    parts = _parts(cache)
    assert dg.eager_reason(model, parts) == "cpu device"
    part = next(p for p in parts if p is not None)
    part.shards = object()                   # what a cache on a mesh holds
    assert dg.eager_reason(model, parts) == "sharded cache"


def test_autograd_keeps_the_step_eager_and_no_grad_does_not():
    model, cache = _decoder(get_reduced("mamba2-780m"))
    parts = _parts(cache)
    model.requires_grad_(True)
    assert dg.eager_reason(model, parts) == "autograd"
    with torch.no_grad():
        assert dg.eager_reason(model, parts) == "cpu device"
    model.requires_grad_(False)      # weights that take no gradient: nothing is recorded
    assert dg.eager_reason(model, parts) == "cpu device"


def test_graphs_are_kept_by_cache_and_dropped_with_it_or_by_a_move():
    model, cache = _decoder(HYBRID)
    assert isinstance(cache, HybridCache)
    graphs = model.decode_graphs(cache)
    assert model.decode_graphs(cache) is graphs
    other = model.init_cache(2, 40)
    assert model.decode_graphs(other) is not graphs
    del other
    assert len(model._decode_graphs) == 1
    model.to(torch.float32)                  # new storage: graphs captured before are stale
    assert model.decode_graphs(cache) is not graphs


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b"])
def test_serve_prints_the_decode_step_counts(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "5", "--page-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "SERVING DONE"
    assert lines[-2] == "decode steps: " + str(res.model.decode_graphs(res.cache).snapshot())
    assert ast.literal_eval(lines[-2].removeprefix("decode steps: ")) == {
        "replays": 0, "captures": {}, "eager": {"cpu device": 5}}


# ---------------------------------------------------------------------------
# the bookkeeping, with fakes for the CUDA calls
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Records the body's work while "capturing", runs it again at replay."""

    capturing = None

    def __init__(self):
        self.work = []
        self.pool = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.pool = pool
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None

    def replay(self):
        for fn in self.work:
            fn()


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeEvent:
    log = []

    def synchronize(self):
        _FakeEvent.log.append(("wait", id(self)))

    def record(self, stream=None):
        _FakeEvent.log.append(("record", id(self)))


class _Body:
    """A decode body of ``kernels`` paged launches a step: adds the input to
    an in-place state and writes it into its output."""

    def __init__(self, kernels: int):
        self.kernels, self.state, self.keys = kernels, torch.zeros(2), []

    def __call__(self, inp, key):
        out = torch.empty(2)

        def work():                           # what the device runs, at a replay too
            self.state += inp.float()
            out.copy_(self.state)
        self.keys.append(key)
        if _FakeGraph.capturing is not None:
            _FakeGraph.capturing.work.append(work)
        else:
            work()
        pa.launches += self.kernels              # the wrappers count each call, captured too
        return out


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", 1))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "log", [])
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(pa, "launches", 0)


def test_warm_up_then_captures_from_a_new_key_up_then_replays(fake_cuda):
    """Keys as a paged pool's, most_blocks 34: the first new key captures
    itself and every key above it; a lower key met later only itself."""
    graphs, body = dg.DecodeGraphs(CPU), _Body(kernels=5)
    keys = [31, 31, 31, 32, 32, 31, 33, 34, 30, 31]
    outs = [graphs.run(body, torch.full((2,), float(i)), None, range(k, 35))
            for i, k in enumerate(keys)]
    # each step's output: the running sum of the inputs, every step run once
    np.testing.assert_array_equal([o[0].item() for o in outs], np.cumsum(range(len(keys))))
    assert pa.launches == 5 * len(keys)
    snap = graphs.snapshot()
    assert snap == {"replays": len(keys) - 1,
                    "captures": {"31": 1, "32": 1, "33": 1, "34": 1, "30": 1},
                    "eager": {dg.WARM_UP: 1}}
    assert snap["replays"] + sum(snap["eager"].values()) == len(keys)
    assert body.keys == [31, 31, 32, 33, 34, 30]   # warm-up, then one capture a key
    assert {g.graph.pool for g in graphs.graphs.values()} == {("pool", 1)}
    assert all(g.launches == (5, 0, 0, 0, 0) for g in graphs.graphs.values())
    # before each replay the host waits for the one two replays back, then
    # records its own end on the same event
    events = [e for _, e in _FakeEvent.log]
    assert [k for k, _ in _FakeEvent.log] == ["wait", "record"] * (len(keys) - 1)
    assert events[::2] == events[1::2] and len(set(events)) == dg.AHEAD
    assert events[0:2] != events[2:4] and events[0:2] == events[4:6]


def test_a_returned_output_is_a_copy(fake_cuda):
    graphs, body = dg.DecodeGraphs(CPU), _Body(kernels=1)
    first = [graphs.run(body, torch.ones(2), None, (None,)) for _ in range(3)]
    assert [o[0].item() for o in first] == [1.0, 2.0, 3.0]
    assert first[1].data_ptr() != first[2].data_ptr()


def test_an_input_of_another_shape_gets_its_own_graph(fake_cuda):
    graphs, body = dg.DecodeGraphs(CPU), _Body(kernels=0)
    graphs.run(body, torch.ones(2), None, (None,))             # warm-up
    graphs.run(body, torch.ones(2), None, (None,))             # capture
    graphs.run(body, torch.ones(2, dtype=torch.float64), None, (None,))
    assert len(graphs.graphs) == 2 and graphs.snapshot()["captures"] == {"None": 2}


def test_eager_steps_are_counted_by_reason(fake_cuda):
    graphs, body = dg.DecodeGraphs(CPU), _Body(kernels=2)
    graphs.run(body, torch.ones(2), "cpu device", (7, 8))
    graphs.run(body, torch.ones(2), "autograd", (7,))
    graphs.run(body, torch.ones(2), "autograd", (7,))
    assert graphs.snapshot() == {"replays": 0, "captures": {},
                                 "eager": {"cpu device": 1, "autograd": 2}}
    assert not graphs.graphs and graphs.stream is None and pa.launches == 6
    assert body.keys == [7, 7, 7]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the paged kernel have no CPU mode")
    return torch.device("cuda")


def _pair(cfg, batch, max_len, dev, prompt=None, **cache_kw):
    """Two copies of one model and cache, prefilled with the same prompt."""
    out = []
    for _ in range(2):
        model = init_transformer(cfg, seed=0, device=dev)
        cache = model.init_cache(batch, max_len, **cache_kw)
        if prompt is not None:
            with torch.no_grad():
                model.prefill(prompt, cache)
        out.append((model, cache))
    return out


def _eager(model, cache, inp, cur):
    """(the step's eager body run directly, what the graph captured; its
    plan's launch keys)."""
    kv, ssm = _parts(cache)
    plan = kv.plan_step(cur) if kv is not None else None
    return model._decode_body(kv, ssm, plan, inp), (None,) if plan is None else plan.launch_keys


def _replay_equals_eager(cfg, batch, max_len, positions, dev, prompt=None, **cache_kw):
    """Feeds both copies the same tokens at ``positions`` (steps, B); the
    graph copy's logits must equal the eager copy's bit for bit."""
    (gm, gc), (em, ec) = _pair(cfg, batch, max_len, dev, prompt, **cache_kw)
    rng = np.random.default_rng(0)
    keys, captured = [], set()
    with torch.no_grad():
        for cur in positions:
            if cfg.frontend:
                inp = torch.from_numpy(rng.normal(size=(batch, cfg.d_model))).to(
                    dev, torch.bfloat16)
            else:
                inp = torch.from_numpy(rng.integers(0, cfg.vocab_size, batch)).to(dev)
            got = gm.decode_step(gc, inp, cur)
            want, ahead = _eager(em, ec, inp, cur)
            torch.cuda.synchronize()
            assert torch.equal(got, want), cur
            keys.append(ahead[0])
            if len(keys) > 1 and ahead[0] not in captured:
                captured |= set(ahead)
    snap = gm.decode_graphs(gc).snapshot()
    assert snap["eager"] == {dg.WARM_UP: 1}
    assert snap["replays"] == len(positions) - 1
    # the first step warms the capture stream; from the second on, a key met
    # for the first time is captured with every key above it, once each
    assert snap["captures"] == {str(k): 1 for k in captured}
    return snap, keys


def test_paged_replay_equals_eager_across_keys_and_a_turn_reset(cuda):
    """48 steps of three sequences over 16-token blocks: the longest needs 2,
    then 3 blocks until sequence 0's turn ends at step 20 and restarts at its
    history (2 again), then 3 and 4: ``live_blocks`` keys come and go."""
    B, prompt = 3, 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, DENSE.vocab_size,
                                                              (B, prompt))).to(cuda)
    hist = np.array([prompt, prompt - 16, prompt - 20])
    positions, cur = [], hist.copy()
    for step in range(48):
        positions.append(cur.copy())
        cur += 1
        if step == 20:
            cur[0] = hist[0]
    launches = pa.launches
    _, keys = _replay_equals_eager(DENSE, B, 96, positions, cuda, toks,
                                   page_tokens=4, pages_per_block=4)
    assert keys[0] == 2 and keys[20] == 3 and keys[21] == 2 and keys[-1] == 4
    # every step ran the paged kernel once a layer in each copy, replays counted
    assert pa.launches - launches == 2 * DENSE.num_layers * len(positions)


def test_ring_and_ssm_replay_equals_eager_through_the_wrap(cuda):
    B, prompt = 2, 8
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, HYBRID.vocab_size,
                                                              (B, prompt))).to(cuda)
    positions = [np.array([prompt + i, prompt + i]) for i in range(40)]   # ring of 16
    snap, keys = _replay_equals_eager(HYBRID, B, 200, positions, cuda, toks)
    assert set(keys) == {None} and snap["captures"] == {"None": 1}


def test_reduced_hymba_replays_the_ring_kernel_bit_for_bit(cuda):
    """The reduced hymba (a ring of 64 slots, D 32, G 2) prefilled with 32
    tokens, then 48 steps through the ring's wrap: the captured step runs the
    ring kernel, its replays equal the eager body bit for bit, and every step
    counts the kernel once a layer in each copy."""
    cfg = get_reduced("hymba-1.5b")
    B, prompt = 2, 32
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                              (B, prompt))).to(cuda)
    positions = [np.array([prompt + i, prompt + i]) for i in range(48)]
    launches = ra.launches
    snap, keys = _replay_equals_eager(cfg, B, 200, positions, cuda, toks)
    assert set(keys) == {None} and snap["captures"] == {"None": 1}
    assert ra.launches - launches == 2 * cfg.num_layers * len(positions)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_replays_its_decode_bit_for_bit(arch, cuda):
    """From an empty cache (no prefill: the reduced MLA's head dim is not
    the flash kernel's), 12 steps; MoE and MLA blocks and embedding inputs
    included."""
    cfg = get_reduced(arch)
    positions = [np.full(2, t) for t in range(12)]
    _replay_equals_eager(cfg, 2, 32, positions, cuda, page_tokens=4)


def test_returned_logits_survive_the_next_step(cuda):
    (model, cache), _ = _pair(DENSE, 2, 64, cuda, page_tokens=4)
    tok = torch.zeros(2, dtype=torch.long, device=cuda)
    with torch.no_grad():
        held = [model.decode_step(cache, tok + t, np.full(2, t)) for t in range(4)]
        copies = [h.clone() for h in held]
        for t in range(4, 8):
            model.decode_step(cache, tok + t, np.full(2, t))
    torch.cuda.synchronize()
    assert model.decode_graphs(cache).snapshot()["replays"] == 7
    assert all(torch.equal(h, c) for h, c in zip(held, copies))
    assert len({h.data_ptr() for h in held}) == 4
