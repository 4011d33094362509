"""The program's spans (``repro_torch.spans``) and the decode caches' counters,
on the CPU.

- Under ``torch.profiler`` a two-layer decode step records one
  ``decode.step`` holding ``kv.plan``, a ``layer`` a block with its mixer's
  and FFN's spans inside, and ``decode.logits``: ``layer.attn`` over the
  paged pool, ``layer.attn`` and ``layer.ssm`` over a hybrid's ring and
  state; a prefill records ``prefill.step`` around its layers.
- A training step records ``train.forward`` (its layers inside),
  ``train.backward`` and ``train.optimizer``, one after the other.
- With no profiler running no ``RecordFunction`` is entered, and spans
  change nothing: decode logits and a training step's parameters are
  bitwise the same with the profiler on and off.
- ``PagedKVPool.snapshot()`` reports the pool's reserved bytes and what its
  last ``plan_step`` found live; the ring and the SSM state report their
  bytes; ``launch.serve`` prints every part's snapshot after its decode.
"""

import ast
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ModelConfig, RunConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import HybridCache, PagedKVPool, init_transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.spans import PREFIX  # noqa: E402

DENSE = ModelConfig(name="spans-dense", family="dense", num_layers=2, d_model=64,
                    vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
HYBRID = ModelConfig(name="spans-hybrid", family="hybrid", num_layers=2, d_model=64,
                     vocab_size=128, mixer="hybrid", num_heads=4, num_kv_heads=2,
                     head_dim=16, window=16, d_ff=128, ssm_state=8, ssm_heads=2,
                     ssm_head_dim=32, ssm_chunk=8)
B, PROMPT, MAX_LEN, PAGE = 2, 8, 40, 4


def _spans(prof):
    """[(name without the prefix, start ns, end ns)] of the program's spans, by start."""
    out = [(ev.name()[len(PREFIX):], ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events() if ev.name().startswith(PREFIX)]
    return sorted(out, key=lambda sp: sp[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _decoder(cfg):
    """(model, its cache after a prefill of PROMPT tokens, the next token)."""
    model = init_transformer(cfg, seed=0, device="cpu")
    cache = model.init_cache(B, MAX_LEN, page_tokens=PAGE)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                 (B, PROMPT)))
    with torch.no_grad():
        logits = model.prefill(prompts, cache)
    return model, cache, logits[:, :cfg.vocab_size].argmax(-1)


def _decode(model, cache, tok):
    with torch.no_grad():
        return model.decode_step(cache, tok, np.full(B, PROMPT, np.int64))


def _trainer(cfg):
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    model = init_transformer(cfg, seed=0, device="cpu").requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()), run)
    rows = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 17)))
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    return build_train_step(cfg, run), model, opt, batch


@pytest.mark.parametrize("cfg,mixers", [(DENSE, ("layer.attn",)),
                                        (HYBRID, ("layer.attn", "layer.ssm"))],
                         ids=["paged", "hybrid"])
def test_decode_step_records_its_layers(cfg, mixers):
    model, cache, tok = _decoder(cfg)
    assert isinstance(cache, PagedKVPool if cfg is DENSE else HybridCache)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(model, cache, tok)
    spans = _spans(prof)
    counts = Counter(name for name, _, _ in spans)
    want = {"decode.step": 1, "kv.plan": 1, "layer": 2, "layer.ffn": 2, "decode.logits": 1,
            **{m: 2 for m in mixers}}
    assert counts == want
    step = spans[0]
    assert step[0] == "decode.step" and all(_inside(sp, step) for sp in spans)
    layers = [sp for sp in spans if sp[0] == "layer"]
    for sp in spans:
        if sp[0].startswith("layer."):
            assert sum(_inside(sp, ly) for ly in layers) == 1, sp
    plan = next(sp for sp in spans if sp[0] == "kv.plan")
    assert plan[2] <= layers[0][1]        # the plan is made once, before the first layer


def test_prefill_records_its_layers():
    model = init_transformer(HYBRID, seed=0, device="cpu")
    cache = model.init_cache(B, MAX_LEN)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model.prefill(torch.zeros((B, PROMPT), dtype=torch.long), cache)
    spans = _spans(prof)
    assert Counter(n for n, _, _ in spans) == {"prefill.step": 1, "layer": 2, "layer.attn": 2,
                                               "layer.ssm": 2, "layer.ffn": 2}
    assert spans[0][0] == "prefill.step" and all(_inside(sp, spans[0]) for sp in spans)


def test_train_step_records_forward_backward_optimizer():
    step, model, opt, batch = _trainer(DENSE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, batch)
    spans = _spans(prof)
    top = [sp for sp in spans if sp[0].startswith("train.")]
    assert [sp[0] for sp in top] == ["train.forward", "train.backward", "train.optimizer"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    layers = [sp for sp in spans if sp[0] == "layer"]
    assert len(layers) == 2 and all(_inside(ly, top[0]) for ly in layers)


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    model, cache, tok = _decoder(HYBRID)
    _decode(model, cache, tok)
    step, tmodel, opt, batch = _trainer(DENSE)
    step(tmodel, opt, batch)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):      # the patch is what spans call
        _decode(model, cache, tok)
    assert calls and all(c.startswith(PREFIX) for c in calls)


@pytest.mark.parametrize("cfg", [DENSE, HYBRID], ids=["paged", "hybrid"])
def test_spans_change_no_output(cfg):
    off = _decode(*_decoder(cfg))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _decode(*_decoder(cfg))
    assert torch.equal(off, on)
    params = []
    for traced in (False, True):
        step, model, opt, batch = _trainer(cfg)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                step(model, opt, batch)
        else:
            step(model, opt, batch)
        params.append(dict(model.named_parameters()))
    assert all(torch.equal(params[0][n], params[1][n]) for n in params[0])


def test_paged_pool_snapshot():
    model, cache, tok = _decoder(DENSE)
    L, Kh, D = DENSE.num_layers, DENSE.num_kv_heads, DENSE.head_dim
    token_bytes = L * 2 * Kh * D * 2                               # K and V, bf16
    pages = B * MAX_LEN // PAGE + cache.pages_per_block - 1       # and the slack pages
    reserved = pages * PAGE * token_bytes
    assert cache.snapshot() == {"reserved_bytes": reserved, "live_tokens": 0,
                                "live_bytes": 0, "live_blocks": 0}
    with torch.no_grad():
        model.decode_step(cache, tok, np.array([20, 5]))
    # lengths 21 and 6; blocks of 4 pages of 4 tokens: 2 descriptors and 1 hold them
    assert cache.snapshot() == {"reserved_bytes": reserved, "live_tokens": 27,
                                "live_bytes": 27 * token_bytes, "live_blocks": 3}


def test_ring_and_state_snapshots():
    cache = init_transformer(HYBRID, seed=0, device="cpu").init_cache(B, MAX_LEN)
    L, Kh, D, W = HYBRID.num_layers, HYBRID.num_kv_heads, HYBRID.head_dim, HYBRID.window
    assert cache.kv.snapshot() == {"reserved_bytes": 2 * L * B * W * Kh * D * 2}
    H, P, N = HYBRID.ssm_heads, HYBRID.ssm_head_dim, HYBRID.ssm_state
    conv = L * B * 3 * (H * P + 2 * N) * 4
    assert cache.ssm.snapshot() == {"reserved_bytes": conv + L * B * H * N * P * 4}


def _printed_snapshots(out: str) -> dict:
    lead = "decode cache after the last step: "
    line = next(ln for ln in out.splitlines() if ln.startswith(lead))
    return ast.literal_eval(line.removeprefix(lead))


def test_serve_prints_the_pool_snapshot(capsys):
    res = serve.main(["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "20",
                      "--gen", "6", "--page-tokens", "4"])
    snaps = _printed_snapshots(capsys.readouterr().out)
    assert snaps == {"PagedKVPool": res.cache.snapshot()}
    snap = snaps["PagedKVPool"]
    assert snap["live_tokens"] == 3 * 26 and 0 < snap["live_bytes"] < snap["reserved_bytes"]


def test_serve_prints_the_ring_and_state_snapshots(capsys):
    res = serve.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3"])
    assert isinstance(res.cache, HybridCache)
    snaps = _printed_snapshots(capsys.readouterr().out)
    assert snaps == {"RingKVCache": res.cache.kv.snapshot(),
                     "SSMCache": res.cache.ssm.snapshot()}
    assert all(s["reserved_bytes"] > 0 for s in snaps.values())
