"""repro_torch.configs.optimized against the reference's, and the knobs it flips.

- ``optimize(cfg, only=...)`` flips the same fields to the same values as
  ``repro.configs.optimized.optimize`` for every arch, every single knob, all
  knobs at once and ``only=set()``; the port's ``DEFAULT_ON`` is its own (a
  subset of ``KNOBS``), exactly the knobs that ``tools/knob_table.py``'s rule
  turns on for the dry-run table that decided it (PERF.md §6, its terms
  written here).
- The plain flash path under the attention knobs (``blocks``: tiles of 1024;
  ``swa``: the sliced sliding window; ``flash_bf16``: operands in q's dtype,
  P rounded before P·V) against the reference's ``flash_attention_jnp`` with
  the same arguments, in f32 at 2e-5 (``FLASH_TOL``, tests/test_kernels.py's
  flash tolerance), and ``flash_bf16`` on bf16 inputs within one bf16 step of
  the output (``BF16_TOL``); then ``attention_train`` of a reduced arch under
  each knob against the reference's on the same f32 weights (2e-5).
- Where the reference's ``_moe_shard_map`` returns ``None`` the port runs the
  global dispatch: on plain tensors, on a mesh with no "model" axis, and where
  neither E nor ``moe_d_ff`` divides the model axis, the knobbed layer
  computes and communicates exactly what the unknobbed one does.
- The dry run's ``--knobs``/``--opt``: rows keyed by the variant, the MoE
  cell's collective bytes lowered by ``moe``.

The knobs on a multi-rank mesh are held to the reference's shard_map in
tests/test_torch_mesh_ranks.py, and their counts on the 16×16 mesh to the
reference's HLO in tests/test_torch_roofline.py.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import optimized as ref_opt  # noqa: E402
from repro.models.attention import attention_train as ref_attention_train  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402

from repro_torch.configs import ARCH_IDS, ModelConfig, get_config  # noqa: E402
from repro_torch.configs import optimized as opt  # noqa: E402
from repro_torch.configs.base import port_only_at_defaults, shared_fields  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402

FLASH_TOL = 2e-5      # f32, tests/test_kernels.py's flash tolerance
BF16_TOL = 2 ** -7    # bf16 outputs: one step of bf16's 8-bit mantissa, relative

ONLY = [set(), *({k} for k in ref_opt.KNOBS), set(ref_opt.KNOBS)]


def test_knobs_are_the_references_and_default_on_a_subset():
    assert opt.KNOBS == ref_opt.KNOBS
    assert opt.DEFAULT_ON <= set(opt.KNOBS)


@pytest.mark.parametrize("only", ONLY, ids=lambda o: "+".join(sorted(o)) or "none")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimize_flips_the_references_fields(arch, only):
    ref_cfg = ref_config(arch)
    port_cfg = get_config(arch)
    want = dataclasses.asdict(ref_opt.optimize(ref_cfg, only=set(only)))
    got = opt.optimize(port_cfg, only=set(only))
    assert shared_fields(got) == want and port_only_at_defaults(got)
    if not only:
        assert opt.optimize(port_cfg, only=set()) == port_cfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_is_the_ports_own_set(arch):
    cfg = get_config(arch)
    assert opt.optimize(cfg) == opt.optimize(cfg, only=set(opt.DEFAULT_ON))
    want = ref_opt.optimize(ref_config(arch), only=set(opt.DEFAULT_ON))
    assert shared_fields(opt.optimize(cfg)) == dataclasses.asdict(want)


def _terms(compute, memory, min_memory, collective) -> dict:
    return dict(compute_s=compute, memory_s=memory, min_memory_s=min_memory,
                collective_s=collective, hlo_flops=compute, status="ok")


def _scaled(base: dict, compute=0.0, memory=0.0) -> dict:
    return {**base, "compute_s": base["compute_s"] * (1 + compute),
            "hlo_flops": base["compute_s"] * (1 + compute),
            "memory_s": base["memory_s"] * (1 + memory)}


# PERF.md §6's dry-run table (tools/knob_table.py, 16×16, one device's terms in
# ms at the H100 constants): each cell's base and each knob's terms, the scan
# chunks' as the table's changes of base's
KT_BASE = {
    ("deepseek-v2-lite-16b", "train_4k"): _terms(1381.593, 22251.533, 1.582, 11620.558),
    ("deepseek-v2-lite-16b", "prefill_32k"): _terms(368.602, 6649.166, 0.728, 4655.267),
    ("deepseek-v2-lite-16b", "decode_32k"): _terms(0.138, 4.970, 1.033, 1.701),
    ("qwen2-moe-a2.7b", "train_4k"): _terms(1132.403, 19652.365, 1.343, 1775.419),
    ("qwen2-moe-a2.7b", "prefill_32k"): _terms(301.804, 5797.113, 0.778, 702.108),
    ("qwen2-moe-a2.7b", "decode_32k"): _terms(0.047, 2.426, 1.499, 0.086),
    ("mamba2-780m", "train_4k"): _terms(40.405, 1354.547, 0.086, 1286.180),
    ("mamba2-780m", "prefill_32k"): _terms(9.696, 239.320, 0.037, 161.538),
    ("hymba-1.5b", "train_4k"): _terms(170.017, 1575.060, 0.157, 843.663),
    ("hymba-1.5b", "prefill_32k"): _terms(39.843, 374.567, 0.092, 141.564),
}
KT_KNOB = {
    "moe": {
        ("deepseek-v2-lite-16b", "train_4k"): _terms(129.492, 1421.306, 1.582, 203.771),
        ("deepseek-v2-lite-16b", "prefill_32k"): _terms(50.740, 352.277, 0.728, 48.915),
        ("deepseek-v2-lite-16b", "decode_32k"): _terms(0.111, 4.200, 1.033, 1.107),
        ("qwen2-moe-a2.7b", "train_4k"): _terms(97.584, 2032.277, 1.343, 217.763),
        ("qwen2-moe-a2.7b", "prefill_32k"): _terms(34.501, 486.265, 0.778, 43.546),
        ("qwen2-moe-a2.7b", "decode_32k"): _terms(0.018, 1.863, 1.499, 0.005),
    },
    "mla_lat": {
        ("deepseek-v2-lite-16b", "train_4k"): KT_BASE[("deepseek-v2-lite-16b", "train_4k")],
        ("deepseek-v2-lite-16b", "prefill_32k"):
            KT_BASE[("deepseek-v2-lite-16b", "prefill_32k")],
        ("deepseek-v2-lite-16b", "decode_32k"): _terms(0.138, 4.970, 1.033, 2.644),
    },
    "ssd_chunk": {
        ("mamba2-780m", "train_4k"): _scaled(KT_BASE[("mamba2-780m", "train_4k")],
                                             -0.1276, 0.0024),
        ("mamba2-780m", "prefill_32k"): _scaled(KT_BASE[("mamba2-780m", "prefill_32k")],
                                                -0.1208),
        ("hymba-1.5b", "train_4k"): _scaled(KT_BASE[("hymba-1.5b", "train_4k")],
                                            -0.1849, 0.0029),
        ("hymba-1.5b", "prefill_32k"): _scaled(KT_BASE[("hymba-1.5b", "prefill_32k")],
                                               -0.1970),
    },
    "ssd_chunk128": {
        ("mamba2-780m", "train_4k"): _scaled(KT_BASE[("mamba2-780m", "train_4k")],
                                             -0.0850, 0.0008),
        ("mamba2-780m", "prefill_32k"): _scaled(KT_BASE[("mamba2-780m", "prefill_32k")],
                                                -0.0805),
        ("hymba-1.5b", "train_4k"): _scaled(KT_BASE[("hymba-1.5b", "train_4k")],
                                            -0.1232, 0.0010),
        ("hymba-1.5b", "prefill_32k"): _scaled(KT_BASE[("hymba-1.5b", "prefill_32k")],
                                               -0.1313),
    },
    # the attention knobs change no count (every attention cell as base)
    **{k: dict(KT_BASE) for k in ("blocks", "flash_bf16", "swa")},
}


def test_default_on_is_the_dry_run_tables_verdict():
    """``DEFAULT_ON`` is exactly the set that ``tools/knob_table.py``'s rule
    turns on for the table that decided it."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "knob_table.py"
    spec = importlib.util.spec_from_file_location("knob_table", path)
    knob_table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(knob_table)
    rows = [{**t, "arch": a, "shape": s, "knob": "base"} for (a, s), t in KT_BASE.items()]
    rows += [{**t, "arch": a, "shape": s, "knob": k}
             for k, cells in KT_KNOB.items() for (a, s), t in cells.items()]
    verdicts = knob_table.verdicts(rows)
    assert {k for k, (on, _) in verdicts.items() if on} == opt.DEFAULT_ON, verdicts


# (knob, B, S, H, Kh, D, window): each knob's own branch of the plain path
FLASH_CASES = {
    "blocks": (1, 2048, 4, 2, 32, None),        # tiles of 1024: two of each
    "swa": (1, 1024, 4, 2, 32, 64),             # 1024 > window + q_block: sliced
    "flash_bf16": (2, 256, 4, 2, 32, None),
}


def _knob_kwargs(knob: str) -> dict:
    cfg = opt.optimize(dataclasses.replace(get_config("hymba-1.5b"), window=64),
                       only={knob})
    return dict(q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
                bf16_compute=cfg.flash_bf16, swa_sliced_kv=cfg.swa_sliced_kv)


def _qkv(B, S, H, Kh, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (H, Kh, Kh))


@pytest.mark.parametrize("knob", list(FLASH_CASES))
def test_plain_flash_under_the_knob_matches_the_reference_f32(knob):
    B, S, H, Kh, D, window = FLASH_CASES[knob]
    kw = _knob_kwargs(knob)
    assert kw != _knob_kwargs_none()
    q, k, v = _qkv(B, S, H, Kh, D)
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               window=window, **kw)
    got = flash_attention_op(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=True, window=window, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_TOL, atol=FLASH_TOL)


def _knob_kwargs_none() -> dict:
    cfg = get_config("hymba-1.5b")
    return dict(q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
                bf16_compute=cfg.flash_bf16, swa_sliced_kv=cfg.swa_sliced_kv)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_flash_bf16_rounds_p_as_the_reference(window):
    """bf16 inputs: with ``flash_bf16`` both round P to bf16 before P·V; the
    outputs (bf16) agree within one bf16 step. Without the knob the plain
    version keeps P in f32, so the knob changes what it computes."""
    B, S, H, Kh, D = 2, 256, 4, 2, 32
    q, k, v = _qkv(B, S, H, Kh, D, seed=1)
    qj, kj, vj = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    qt, kt, vt = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    want = np.asarray(flash_attention_jnp(qj, kj, vj, causal=True, window=window,
                                          bf16_compute=True).astype(jnp.float32))
    got = flash_attention_op(qt, kt, vt, causal=True, window=window, bf16_compute=True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)
    f32_p = flash_attention_op(qt, kt, vt, causal=True, window=window)
    assert not torch.equal(f32_p, got)


# (knob, arch, S): attention_train of a reduced arch under the knob
LAYER_CASES = [("blocks", "qwen1.5-0.5b", 2048), ("swa", "hymba-1.5b", 1024),
               ("flash_bf16", "qwen1.5-0.5b", 128)]


@pytest.mark.parametrize("knob,arch,S", LAYER_CASES)
def test_attention_train_under_the_knob_matches_the_reference(knob, arch, S):
    """The config's knob fields reach the plain flash path through
    ``models/attention.py``: f32 weights and inputs, both packages."""
    import torch_parity as tp
    from repro_torch.models.attention import attention_train
    ref_cfg = ref_opt.optimize(tp.ref_get_reduced(arch), only={knob})
    port_cfg = opt.optimize(ModelConfig(**dataclasses.asdict(tp.ref_get_reduced(arch))),
                            only={knob})
    assert dataclasses.asdict(ref_cfg) == shared_fields(port_cfg)
    _, params, model = tp.models(arch)
    leaves = {n: np.asarray(a[0], np.float32) for n, a in params["blocks"]["attn"].items()}
    mod = copy.deepcopy(model.blocks[0].attn).float()      # the reference's layer 0
    x = np.random.default_rng(5).normal(size=(1, S, ref_cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None]
    want = ref_attention_train({n: jnp.asarray(a) for n, a in leaves.items()},
                               jnp.asarray(x), ref_cfg, jnp.asarray(pos))
    with torch.no_grad():
        got = attention_train(mod, torch.from_numpy(x), port_cfg, torch.from_numpy(pos))[0]
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               rtol=FLASH_TOL, atol=FLASH_TOL)


@torch.no_grad()
def test_moe_knob_on_plain_tensors_is_the_global_dispatch():
    """No mesh (plain tensors): ``_moe_shard_map`` returns None, as the
    reference's does with no mesh, and the layer is the global dispatch, bit
    for bit."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import MoE, _moe_shard_map, moe_apply
    cfg = get_reduced("deepseek-v2-lite-16b")
    on = opt.optimize(cfg, only={"moe"})
    assert on.moe_shard_map
    torch.manual_seed(0)
    mod = MoE(cfg, device=torch.device("cpu")).float()
    for p in mod.parameters():
        p.normal_(0, 0.1)
    x = torch.randn(2, 16, cfg.d_model)
    assert _moe_shard_map(mod, x, on) is None
    y0, a0 = moe_apply(mod, x, cfg)
    y1, a1 = moe_apply(mod, x, on)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


@pytest.fixture
def fake_mesh():
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.close_mesh()
    yield mesh_mod.make_production_mesh()
    mesh_mod.close_mesh()


# where the reference's _moe_shard_map returns None on a mesh: (arch, widths, mesh axes)
FALLBACK_CASES = {
    "no_model_axis": ("deepseek-v2-lite-16b", dict(d_model=256, num_experts=16), ("data",)),
    "neither_divides": ("qwen2-moe-a2.7b", dict(d_model=256, num_experts=6, moe_d_ff=72),
                        ("data", "model")),
}


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_moe_knob_falls_back_where_the_reference_does(case, fake_mesh):
    """On the fake 16×16 group: a mesh with no "model" axis (256 ranks on
    "data"), or qwen2-moe with 6 experts (its rules keep "experts" off
    "model") and ``moe_d_ff`` 72, which 16 does not divide. ``_moe_shard_map``
    returns None and the knobbed layer counts the same FLOPs, bytes and
    collectives as the unknobbed one: the global dispatch."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import distribute, placements, rules_for, spec_for
    from repro_torch.models.moe import MoE, _moe_shard_map, moe_apply
    from repro_torch.roofline.count import count
    arch, widths, axes = FALLBACK_CASES[case]
    mesh = fake_mesh if len(axes) == 2 else init_device_mesh("cpu", (256,),
                                                             mesh_dim_names=axes)
    cfg = dataclasses.replace(get_reduced(arch), **widths)
    on = opt.optimize(cfg, only={"moe"})
    mod = MoE(cfg, device=torch.device("meta"))
    rules = rules_for(cfg)
    for name, p in list(mod.named_parameters()):
        pl = placements(spec_for(p.shape, MoE.AXES[name], mesh, rules), mesh)
        setattr(mod, name, torch.nn.Parameter(distribute(p, mesh, pl), requires_grad=False))
    x = torch.empty(256, 2, cfg.d_model, dtype=torch.bfloat16, device="meta")
    x = distribute(x, mesh, placements(("data",), mesh))
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        assert _moe_shard_map(mod, x, on) is None
        base, _ = count(moe_apply, mod, x, cfg)
        knob, _ = count(moe_apply, mod, x, on)
    assert (knob.flops, knob.bytes, knob.coll_bytes) == (base.flops, base.bytes,
                                                         base.coll_bytes)


def test_dry_run_knobs_and_opt_rows(tmp_path):
    """``--knobs moe`` and ``--opt`` on qwen2-moe-a2.7b's decode_32k at full
    size on the 16×16 mesh (meta): rows keyed "moe" and "opt" beside "base";
    the knob lowers one device's collective bytes; ``variant_compare`` prints
    the three."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    out = tmp_path / "dry.json"
    cell = ["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--out", str(out)]
    dryrun.main(cell)
    dryrun.main(cell + ["--knobs", "moe", "--variant", "moe"])
    dryrun.main(cell + ["--opt"])
    rows = {r["variant"]: r for r in json.loads(out.read_text())}
    assert set(rows) == {"base", "moe", "opt"}
    assert all(r["status"] == "ok" for r in rows.values())
    assert rows["opt"]["key"] == ["qwen2-moe-a2.7b", "decode_32k", "single", "opt"]
    assert rows["moe"]["collective_s"] < rows["base"]["collective_s"]
    if "moe" in opt.DEFAULT_ON:
        assert rows["opt"]["collective_s"] == rows["moe"]["collective_s"]
    table = report.variant_compare(report.load(str(out)), "qwen2-moe-a2.7b", "decode_32k",
                                   ["base", "moe", "opt"])
    assert all(f"| {v} |" in table for v in ("base", "moe", "opt"))
