"""The plain reference against a direct recurrence and against the
program's own plain path at a small size in float32, and its control
(float8 products) caught by the cells' limits at a small size."""

import numpy as np
import pytest
import torch

from bench.lib import spec
from bench.lib.weights import Weights
from bench.tests.cells import DENSE, HYBRID, SEED, run_small

torch.set_num_threads(1)
ref = spec.Cell("command-r-35b.decode").reference()


def test_chunked_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, L, H, P, N = 2, 50, 3, 4, 5
    x = torch.randn(B, L, H, P, generator=g)
    Bm, Cm = torch.randn(B, L, N, generator=g), torch.randn(B, L, N, generator=g)
    dt = torch.rand(B, L, H, generator=g)
    A = -torch.rand(H, generator=g) - 0.5
    h = torch.zeros(B, H, N, P)
    ys = []
    for t in range(L):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    want = torch.stack(ys, 1)
    got = ref.ssd_chunked(x, Bm, Cm, dt, A, chunk=16)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cell,sizes", [("command-r-35b.decode", DENSE),
                                        ("hymba-1.5b.decode", HYBRID)])
def test_reference_matches_the_programs_plain_path_in_f32(cell, sizes):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Transformer
    m = {**spec.Cell(cell).config["model"], **sizes}
    w = Weights(ref.groups(m), ref.full_name, SEED, "cpu")
    model = Transformer(ModelConfig(**m), device="meta").to_empty(device="cpu")
    w.fill(dict(model.named_parameters()))
    model = model.float()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, m["vocab_size"], (2, 96)))
    with torch.no_grad():
        want = model(tokens)[..., : m["vocab_size"]]
    got = ref.logits_at(w.group, m, tokens, [list(range(96))] * 2)
    for b in range(2):
        err = (got[b] - want[b]).abs().max() / want[b].abs().max()
        assert err < 1e-4, float(err)


def test_weights_fill_matches_group_draws():
    m = {**spec.Cell("hymba-1.5b.decode").config["model"], **HYBRID}
    w = Weights(ref.groups(m), ref.full_name, SEED, "cpu")
    params = {n: torch.empty(s, dtype=torch.bfloat16) for g, leaves in w.groups
              for n, s in ((w.full_name(g, leaf[0]), leaf[1]) for leaf in leaves)}
    w.fill(params)
    for g, _ in w.groups:
        for leaf, t in w.group(g).items():
            assert torch.equal(params[w.full_name(g, leaf)], t)
    other = Weights(ref.groups(m), ref.full_name, SEED + 1, "cpu")
    assert not torch.equal(other.group("blocks.0")["attn.wq"], w.group("blocks.0")["attn.wq"])


@pytest.mark.parametrize("cell", ["command-r-35b.decode", "command-r-35b.prefill",
                                  "hymba-1.5b.decode", "hymba-1.5b.train"])
def test_control_reads_far_above_the_program(cell):
    """The control (the reference with float8 products in the program's place)
    over the same prompts and tokens, on three seeds: for one of the cell's
    numbers its largest reading is over three times the program's largest."""
    prog, ctl = {}, {}
    for seed in (SEED, SEED + 1, SEED + 2):
        out = run_small(cell, seed=seed, control="fp8")
        for k, c in out["checks"].items():
            prog[k] = max(prog.get(k, 0.0), c["value"])
            ctl[k] = max(ctl.get(k, 0.0), out["notes"]["control"][k])
    assert any(ctl[k] > 3 * prog[k] for k in prog), (prog, ctl)


@pytest.mark.parametrize("cell", ["command-r-35b.decode", "command-r-35b.prefill",
                                  "hymba-1.5b.decode", "hymba-1.5b.train"])
def test_control_is_not_correct_at_the_cells_limits(cell):
    """The control's readings go through the same limits as the program's:
    on each of three seeds the program is correct and the control is not."""
    for seed in (SEED + 10, SEED + 11, SEED + 12):
        out = run_small(cell, seed=seed, control="fp8")
        assert out["correct"], out["checks"]
        assert out["control"]["correct"] is False, out["control"]
        assert set(out["control"]["checks"]) == set(out["checks"])
