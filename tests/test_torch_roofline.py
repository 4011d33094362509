"""The port's roofline: report math on the H100's constants, one device's
counts on meta, and the dry run.

Twins of tests/test_roofline.py's test_roofline_terms_unit,
test_dominant_term, test_model_flops_train_vs_decode and
test_moe_active_params_smaller, on the H100 SXM constants (989 TFLOP/s
bf16, 3.35 TB/s, 450 GB/s of NVLink a direction). Then: a product on the
16×16 fake mesh counts one device's FLOPs, not the global op's; the byte
rule of ``roofline.count``; the meta count of reduced qwen1.5-0.5b and
mamba2-780m steps against the reference's HLO analyzer on its compiled
step (a 1×1 mesh on the CPU, as test_hlo_analyzer_loop_flops_exact runs it),
within 5 %; one device's count on the 16×16 production mesh against the
reference's per-device count on 256 forced host devices, for a dense, a GQA
and an SSM arch, within 5 %; each default-on knob of ``configs.optimized``
on the same mesh at reduced MoE widths, its collective bytes below base's and
its FLOPs within 5 % of the reference's count with the knob; the dry run's
rows and tables.

The reference's prefill computes the unembedding for every prompt position
and slices the last; the port's computes it for the last only. The prefill
comparison adds that term, 2·B·(S − 1)·M·V, to the port's count.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import SHAPES, RunConfig, ShapeConfig, get_config, get_reduced  # noqa: E402,E501
from repro_torch.configs import optimized  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.analysis import RooflineReport, model_flops_for  # noqa: E402
from repro_torch.roofline.count import count  # noqa: E402

PEAK, HBM, LINK = 989e12, 3.35e12, 450e9


def _rep(**kw):
    base = dict(arch="a", shape="s", mesh="single", chips=256,
                hlo_flops=PEAK, hlo_bytes=HBM, coll_bytes={"all-reduce": LINK},
                model_flops=PEAK * 256)
    base.update(kw)
    return RooflineReport(**base)


def test_roofline_terms_unit():
    r = _rep()
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.bound_s == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1.0)
    # f32 work at 3×TF32's 165 TFLOP/s; the minimum-bytes term beside the unfused one
    r = _rep(f32_flops=PEAK / 2, min_bytes=HBM / 4)
    assert r.compute_s == pytest.approx(0.5 + PEAK / 2 / (495e12 / 3))
    assert r.min_memory_s == pytest.approx(0.25)
    assert r.floor_s == pytest.approx(max(r.compute_s, 0.25, 1.0))


def test_dominant_term():
    assert _rep(hlo_bytes=HBM * 10).dominant == "memory"
    assert _rep(coll_bytes={"all-to-all": LINK * 10}).dominant == "collective"
    assert _rep(hlo_flops=PEAK * 10).dominant == "compute"


def test_model_flops_train_vs_decode():
    cfg = get_config("qwen1.5-0.5b")
    tr = model_flops_for(cfg, SHAPES["train_4k"])
    de = model_flops_for(cfg, SHAPES["decode_32k"])
    assert tr == pytest.approx(6 * cfg.param_count() * 256 * 4096)
    assert de == pytest.approx(2 * cfg.param_count() * 128)


def test_moe_active_params_smaller():
    cfg = get_config("deepseek-v2-lite-16b")
    assert cfg.active_param_count() < cfg.param_count() * 0.35


@pytest.fixture
def production_mesh():
    mesh_mod.close_mesh()
    yield mesh_mod.make_production_mesh()
    mesh_mod.close_mesh()


def test_count_is_one_devices_program(production_mesh):
    """[Shard(0), Replicate()] × [Replicate(), Shard(1)] on 16×16: each device
    multiplies a (16, 1024) by a (1024, 256) shard, no collective; the global
    op (2·256·1024·4096) is never counted. Sharding the inner dim instead
    leaves a partial sum whose reduction is counted as collective bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    a = distribute_tensor(torch.empty(256, 1024, device="meta"), production_mesh,
                          [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(1024, 4096, device="meta"), production_mesh,
                          [Replicate(), Shard(1)])
    c, out = count(torch.mm, a, b)
    assert c.flops == 2 * 16 * 1024 * 256
    assert c.bytes == 4 * (16 * 1024 + 1024 * 256 + 16 * 256)
    assert sum(c.coll_bytes.values()) == 0 and out.to_local().shape == (16, 256)
    b = distribute_tensor(torch.empty(1024, 4096, device="meta"), production_mesh,
                          [Replicate(), Shard(0)])
    c, _ = count(lambda: torch.mm(a, b).full_tensor())
    assert c.flops == 2 * 16 * 64 * 4096
    assert c.coll_bytes["all-reduce"] == 4 * 16 * 4096
    assert c.comm_calls == {"c10d_functional.all_reduce": 1,
                            "c10d_functional.all_gather_into_tensor": 1}


def test_byte_rule_of_views_copies_and_indexed_writes():
    x = torch.empty(64, 32, device="meta")
    c, _ = count(lambda: x.view(32, 64).t())
    assert c.bytes == 0
    y = torch.empty(64, 32, device="meta")
    c, _ = count(lambda: y.copy_(x))
    assert c.bytes == 2 * 64 * 32 * 4
    idx = torch.zeros(8, dtype=torch.long, device="meta")
    vals = torch.empty(8, 32, device="meta")
    c, _ = count(lambda: y.index_put_((idx,), vals))
    assert c.bytes == 2 * 8 * 32 * 4 + 8 * 8
    c, _ = count(lambda: y[idx])
    assert c.bytes == 2 * 8 * 32 * 4 + 8 * 8
    c, _ = count(lambda: x + y)
    assert c.bytes == 3 * 64 * 32 * 4


def _reference_flops(arch: str, kind: str, S: int, B: int) -> float:
    import jax

    from repro.configs import RunConfig as RefRun
    from repro.configs import ShapeConfig as RefShape
    from repro.configs import get_reduced as ref_reduced
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import build_step
    from repro.roofline.hlo_parse import analyze_text
    mesh = make_local_mesh(1, 1)
    with jax.set_mesh(mesh):
        jitted, args = build_step(ref_reduced(arch), RefShape("s", S, B, kind),
                                  RefRun(remat="none"), mesh)
        return analyze_text(jitted.lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m"])
def test_meta_count_matches_the_reference_hlo(arch, kind):
    S, B = 64, 2
    cfg = get_reduced(arch)
    rep = dryrun.roofline_of(cfg, ShapeConfig("s", S, B, kind), RunConfig(remat="none"))
    port = rep.hlo_flops
    if kind == "prefill":            # the reference's logits at every prompt position
        port += 2 * B * (S - 1) * cfg.d_model * cfg.padded_vocab
    ref = _reference_flops(arch, kind, S, B)
    assert abs(port - ref) / ref < 0.05, (port, ref)
    kernels = rep.memory_stats["kernels"]
    want = {"flash_attention"} if cfg.uses_attention else {"ssd_scan"}
    if kind == "train":
        want |= {"flash_attention_bwd"} if cfg.uses_attention else {"ssd_scan_bwd"}
    assert set(kernels) == want
    assert all(k["calls"] == cfg.num_layers for k in kernels.values())


# One device's count on the 16×16 production mesh against the reference's
# per-device HLO count of the same cell (its step compiled for 256 forced host
# devices, in a process of its own). Widths cut so that every sharded axis
# divides the model axis's 16 shards, as the published widths do: a dense MHA
# arch, a GQA arch, an SSM arch.
MESH_CELLS = {
    "qwen1.5-0.5b": dict(d_model=512, num_heads=16, num_kv_heads=16, head_dim=32, d_ff=1024),
    "qwen2.5-32b": dict(d_model=512, num_heads=32, num_kv_heads=8, head_dim=16, d_ff=1024),
    "mamba2-780m": dict(d_model=512, ssm_heads=16, ssm_head_dim=32, ssm_state=16),
}
MESH_S, MESH_B = 64, 32

_REFERENCE_16x16 = """
import json, os, sys, dataclasses
import jax
from repro.configs import RunConfig, ShapeConfig, get_reduced
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_step
from repro.roofline.hlo_parse import analyze_text
from repro.configs.optimized import optimize
cells, S, B = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
knob_cells = json.loads(sys.argv[4])
mesh, out = make_production_mesh(), {}
runs = [(arch, over, kind, "") for arch, over in cells.items() for kind in ("prefill", "train")]
runs += [(arch, over, kind, knob) for knob, arch, over, kind in knob_cells]
for arch, over, kind, knob in runs:
    cfg = dataclasses.replace(get_reduced(arch), **over)
    if knob:
        cfg = optimize(cfg, only={knob})
    with jax.set_mesh(mesh):
        jitted, args = build_step(cfg, ShapeConfig("s", S, B, kind),
                                  RunConfig(remat="none"), mesh)
        flops = analyze_text(jitted.lower(*args).compile().as_text()).flops
    out["/".join(filter(None, (arch, kind, knob)))] = flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_16x16():
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    got = subprocess.run([sys.executable, "-c", _REFERENCE_16x16, json.dumps(MESH_CELLS),
                          str(MESH_S), str(MESH_B), json.dumps(KNOB_CELLS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", list(MESH_CELLS))
def test_count_on_16x16_matches_the_references_device(arch, kind, reference_16x16):
    """Within 5 %, after two named terms. The prefill adds the reference's
    every-position logits (vocab sharded 16 ways). mamba2's ``dt`` product
    (``w_dt`` is ("embed", None), replicated by the rules) runs whole on every
    device in the port, where XLA splits it over "model" to match the
    sharded scan that reads it: the port's count drops 15/16 of it (one
    product in the prefill, three in training: dt, its input gradient and
    w_dt's gradient)."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced(arch), **MESH_CELLS[arch])
    mesh_mod.close_mesh()
    try:
        mesh = mesh_mod.make_production_mesh()
        rep = dryrun.roofline_of(cfg, ShapeConfig("s", MESH_S, MESH_B, kind),
                                 RunConfig(remat="none"), mesh)
    finally:
        mesh_mod.close_mesh()
    port, m, tokens = rep.hlo_flops, 16, MESH_B * MESH_S // 16
    if kind == "prefill":
        port += 2 * (MESH_B // 16) * (MESH_S - 1) * cfg.d_model * cfg.padded_vocab // m
    if cfg.uses_ssm:
        products = 1 if kind == "prefill" else 3
        port -= products * cfg.num_layers * 2 * tokens * cfg.d_model * cfg.ssm_heads \
            * (m - 1) // m
    ref = reference_16x16[f"{arch}/{kind}"]
    assert abs(port - ref) / ref < 0.05, (port, ref)


# Each default-on knob (configs.optimized.DEFAULT_ON) on the 16×16 mesh at
# reduced widths whose sharded axes divide 16: (knob, arch, widths, kind).
# moe: qwen2-moe's 6 experts keep "experts" off "model" (TP on moe_ff 64),
# deepseek's 16 divide it (EP, one a shard).
MOE_WIDTHS = {
    "qwen2-moe-a2.7b": dict(d_model=512, num_heads=16, num_kv_heads=16, head_dim=32,
                            num_experts=6, moe_d_ff=64),
    "deepseek-v2-lite-16b": dict(d_model=512, num_heads=16, kv_lora_rank=64, num_experts=16),
}
KNOB_CELLS = [("moe", arch, over, kind) for arch, over in MOE_WIDTHS.items()
              for kind in ("prefill", "train")]


def test_every_default_knob_has_a_cell_here():
    """A default-on knob with no cell in KNOB_CELLS would go unchecked below."""
    assert optimized.DEFAULT_ON <= {c[0] for c in KNOB_CELLS}


def _knob_cell_ids(cell):
    return "-".join((cell[0], cell[1], cell[3]))


@pytest.mark.parametrize("cell", [c for c in KNOB_CELLS if c[0] in optimized.DEFAULT_ON],
                         ids=_knob_cell_ids)
def test_default_knob_lowers_collectives_and_matches_the_references_flops(
        cell, reference_16x16):
    """One device's collective bytes with the knob below base's; its FLOPs
    within 5 % of the reference's HLO count with the same knob, after the
    prefill's every-position logits and one named term: deepseek's latent
    down-projection (``wkv_a``, ("embed", "lora"): replicated by the rules)
    runs whole on every device in the port, where XLA splits its forward
    product over "model" (15/16 of 2·T·M·(kv_lora + qk_rope) a layer)."""
    import dataclasses
    knob, arch, over, kind = cell
    base_cfg = dataclasses.replace(get_reduced(arch), **over)
    shape = ShapeConfig("s", MESH_S, MESH_B, kind)
    reps = {}
    for name, cfg in (("base", base_cfg), (knob, optimized.optimize(base_cfg, only={knob}))):
        mesh_mod.close_mesh()
        try:
            reps[name] = dryrun.roofline_of(cfg, shape, RunConfig(remat="none"),
                                            mesh_mod.make_production_mesh())
        finally:
            mesh_mod.close_mesh()
    assert sum(reps[knob].coll_bytes.values()) < sum(reps["base"].coll_bytes.values())
    port, m, tokens = reps[knob].hlo_flops, 16, MESH_B * MESH_S // 16
    cfg = base_cfg
    if kind == "prefill":
        port += 2 * (MESH_B // 16) * (MESH_S - 1) * cfg.d_model * cfg.padded_vocab // m
    if cfg.attention == "mla":
        port -= cfg.num_layers * 2 * tokens * cfg.d_model \
            * (cfg.kv_lora_rank + cfg.qk_rope_dim) * (m - 1) // m
    ref = reference_16x16[f"{arch}/{kind}/{knob}"]
    assert abs(port - ref) / ref < 0.05, (port, ref)


def test_dry_run_rows_and_tables(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(out)])
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--out", str(out)])
    rows = json.loads(out.read_text())
    by = {r["shape"]: r for r in rows}
    ok, skipped = by["decode_32k"], by["long_500k"]
    assert ok["status"] == "ok" and ok["key"] == ["qwen1.5-0.5b", "decode_32k", "single",
                                                  "base"]
    assert ok["chips"] == 256 and ok["memory_stats"]["kernels"]["paged_attention"]["calls"] \
        == get_config("qwen1.5-0.5b").num_layers
    assert ok["min_memory_s"] <= ok["memory_s"] * 1.001 and ok["hlo_flops"] > 0
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_supported, get_config as ref_config
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == cell_supported(ref_config("qwen1.5-0.5b"),
                                               REF_SHAPES["long_500k"])[1]
    loaded = report.load(str(out))
    assert "| qwen1.5-0.5b | decode_32k | ok |" in report.dryrun_table(loaded, "single")
    assert "SKIP (documented)" in report.dryrun_table(loaded, "single")
    assert "| qwen1.5-0.5b | decode_32k |" in report.roofline_table(loaded)
