"""The port's configs, logical axes, sharding rules, meshes and step builders
against the reference.

Twins of tests/test_system.py's sharding-rule tests (:94, :100, :106), then:
the configs' exported names and shapes; every reduced arch's logical axes
(parameters and caches) against the reference's spec tree; ``spec_for`` on
the 16×16 and 2×16×16 production mesh shapes, leaf for leaf; ``data_structs``
for the four dry-run shapes; the step builders on a real 1×1 ``gloo`` mesh,
with local shards and with DTensors, against the plain ``Transformer``;
``Checkpointer.restore(..., shardings=)``; the kernel wrappers' meta paths and
their refusal of DTensors; ``chip_smoke.py``'s imports.

Process groups are global state: each test that needs one opens it in a
fixture and closes it after, so nothing leaks between test files in one
worker.
"""

import ast
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, RunConfig, ShapeConfig,  # noqa: E402
                                 get_config, get_reduced)
from repro_torch.distributed.sharding import (DEFAULT_RULES, batch_spec,  # noqa: E402
                                              optim_rules, placements, rules_for,
                                              spec_for, tree_shardings)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.steps import (build_decode_step, build_prefill_step,  # noqa: E402
                                      data_structs, dtensor_mode, param_structs,
                                      place_model, shardings)
from repro_torch.models import init_transformer  # noqa: E402
from repro_torch.models.transformer import cache_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture
def local_mesh():
    mesh_mod.close_mesh()
    mesh = mesh_mod.make_local_mesh(1, 1, device="cpu")
    yield mesh
    mesh_mod.close_mesh()


@pytest.fixture
def production_mesh():
    mesh_mod.close_mesh()
    yield mesh_mod.make_production_mesh()
    mesh_mod.close_mesh()


# ---------------------------------------------------------------------------
# twins of tests/test_system.py's sharding rules
# ---------------------------------------------------------------------------

def test_spec_divisibility_fallback(local_mesh):
    s = spec_for((60, 128), ("experts", "embed"), local_mesh, rules_for())
    assert s == ()   # single device: everything degrades to P()


def test_optim_rules_shard_embed():
    r = optim_rules()
    assert r["embed"] == "data"
    assert DEFAULT_RULES["embed"] is None


def test_arch_overrides_apply():
    cfg = get_reduced("qwen2-moe-a2.7b")
    r = rules_for(cfg)
    assert r["experts"] is None and r["moe_ff"] == "model"


# ---------------------------------------------------------------------------
# configs, axes and specs against the reference
# ---------------------------------------------------------------------------

def test_configs_export_the_reference_names():
    import repro.configs as ref
    import repro_torch.configs as port
    assert port.__all__ == ref.__all__
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    assert list(port.all_configs()) == list(ref.all_configs())
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert port.cell_supported(get_config(arch), SHAPES[name]) == \
                ref.cell_supported(ref.get_config(arch), ref.SHAPES[name])


def _ref_spec_tree(cfg):
    """{dotted leaf name: (the reference's logical axes, its shape)}."""
    from repro.launch.steps import param_structs as ref_param_structs
    shapes, specs = ref_param_structs(cfg)
    return _flat(specs, shapes)


def _ref_name(name: str) -> str:
    parts = name.split(".")
    return ".".join(["blocks", *parts[2:]]) if parts[0] == "blocks" else name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_equal_the_reference_spec_tree(arch):
    """Every parameter's logical axes, mapped through convert.py's names, are
    the reference's with its leading "layers" axis dropped."""
    cfg, port_cfg = tp.reduced(arch)
    ref = _ref_spec_tree(cfg)
    model, axes = param_structs(port_cfg)
    seen = set()
    for name, a in axes.items():
        ref_axes, ref_shape = ref[_ref_name(name)]
        if name.startswith("blocks."):
            assert ref_axes[0] == "layers" and ref_shape[1:] == tuple(
                model.get_parameter(name).shape), name
            ref_axes = ref_axes[1:]
        assert a == ref_axes, name
        seen.add(_ref_name(name))
    assert seen == set(ref)
    from repro.models.transformer import cache_specs as ref_cache_specs
    assert cache_specs(port_cfg) == ref_cache_specs(cfg)


@pytest.mark.parametrize("mesh_kind", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_the_reference(arch, mesh_kind):
    """Full-width shapes on the production mesh shapes: the same entries for
    every parameter (the reference's leading layer entry aside), under the
    arch's rules and under ZeRO-1's, and for every cache leaf."""
    from repro.configs import get_config as ref_get_config
    from repro.distributed import sharding as ref
    from repro.launch.steps import param_structs as ref_param_structs
    from repro.models import transformer as ref_tf
    sizes = PRODUCTION[mesh_kind]
    fake = types.SimpleNamespace(shape=dict(sizes))
    cfg = ref_get_config(arch)
    shapes, specs = ref_param_structs(cfg)
    ref_flat = _flat(specs, shapes)
    _, axes = param_structs(get_config(arch))
    model, _ = param_structs(get_config(arch))
    for rules, ref_rules in ((rules_for(get_config(arch)), ref.rules_for(cfg)),
                             (optim_rules(get_config(arch)), ref.optim_rules(cfg))):
        for name, a in axes.items():
            ref_axes, ref_shape = ref_flat[_ref_name(name)]
            want = tuple(ref.spec_for(ref_shape, ref_axes, fake, ref_rules))
            if name.startswith("blocks."):
                assert want[:1] in ((), (None,)), name
                want = want[1:]
            assert spec_for(tuple(model.get_parameter(name).shape), a, sizes, rules) == \
                want, (name, mesh_kind)
    assert cache_specs(get_config(arch)) == ref_tf.cache_specs(cfg)
    import jax
    cache = jax.eval_shape(lambda: ref_tf.init_cache(cfg, 128, 32768))
    cache_flat = _flat(ref_tf.cache_specs(cfg), cache)
    for name, (c_axes, c_shape) in cache_flat.items():
        assert spec_for(c_shape, c_axes, sizes, rules_for(get_config(arch))) == tuple(
            ref.spec_for(c_shape, c_axes, fake, ref.rules_for(cfg))), name
    for b in (1, 32, 128, 256):
        assert batch_spec(sizes, b) == tuple(ref.batch_spec(fake, b))


def _flat(specs, shapes, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat(v, shapes[k], prefix + k + "."))
        else:
            out[prefix + k] = (tuple(v), tuple(shapes[k].shape))
    return out


def test_tree_shardings_place_each_axis_once(production_mesh):
    """On the 16×16 fake mesh every parameter's placements say what its spec
    says: Shard(d) on a mesh dim exactly where the spec puts that axis."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = get_config("qwen1.5-0.5b")
    model, axes = param_structs(cfg)
    params = dict(model.named_parameters())
    got = tree_shardings(params, axes, production_mesh, rules_for(cfg))
    for name, pl in got.items():
        spec = spec_for(tuple(params[name].shape), axes[name], production_mesh, rules_for(cfg))
        for i, axis in enumerate(production_mesh.mesh_dim_names):
            dims = [d for d, e in enumerate(spec) if e == axis or (
                isinstance(e, tuple) and axis in e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate()), name
    assert got["embed"] == (Replicate(), Shard(0))            # vocab over "model"
    assert got["blocks.0.mlp.wo"] == (Replicate(), Shard(0))  # ffn over "model"
    moments = shardings(cfg, model, production_mesh)[1]
    assert moments["blocks.0.mlp.wo"] == (Shard(1), Shard(0))  # ZeRO-1: embed over data


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-large"])
def test_data_structs_equal_the_reference(arch, shape_name):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_reduced as ref_get_reduced
    from repro.launch.mesh import make_local_mesh as ref_mesh
    from repro.launch.steps import data_structs as ref_data_structs
    ref = ref_data_structs(ref_get_reduced(arch), REF_SHAPES[shape_name], ref_mesh(1, 1))
    port = data_structs(get_reduced(arch), SHAPES[shape_name])
    assert set(port) == set(ref)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert str(port[k].dtype).split(".")[-1].replace("bfloat16", "bf16") == \
            str(ref[k].dtype).replace("bfloat16", "bf16"), k
        assert port[k].device.type == "meta"


def test_production_meshes_and_their_placements(production_mesh):
    from torch.distributed.tensor import Shard
    assert dict(zip(production_mesh.mesh_dim_names, production_mesh.shape)) == \
        PRODUCTION["single"]
    data = data_structs(get_config("qwen1.5-0.5b"), SHAPES["train_4k"], production_mesh)
    assert data["tokens"].placements[0] == Shard(0)
    assert tuple(data["tokens"].to_local().shape) == (16, 4096)
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert dict(zip(multi.mesh_dim_names, multi.shape)) == PRODUCTION["multi"]
    data = data_structs(get_config("qwen1.5-0.5b"), SHAPES["train_4k"], multi)
    assert tuple(data["tokens"].to_local().shape) == (8, 4096)   # (pod, data) on the batch


def test_local_mesh_refuses_more_devices_than_it_sees():
    with pytest.raises(ValueError, match=r"needs 4 devices.*sees 1 cpu device"):
        mesh_mod.make_local_mesh(2, 2, device="cpu")


# ---------------------------------------------------------------------------
# the steps on a real 1×1 mesh against the plain model
# ---------------------------------------------------------------------------

PROMPT, GEN = 32, 3


@pytest.mark.parametrize("as_dtensors", [False, True])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-780m"])
def test_steps_on_a_local_mesh_equal_the_plain_model(arch, as_dtensors, local_mesh):
    """build_prefill_step and build_decode_step on a 1×1 gloo mesh, the model
    on its local shards or as DTensors (the dry run's path, here with real
    values), against the plain Transformer's prefill and decode."""
    cfg = get_reduced(arch)
    shape = ShapeConfig("p", PROMPT, 2, "prefill")
    run = RunConfig()
    plain = init_transformer(cfg, seed=0, device="cpu")
    stepped = init_transformer(cfg, seed=0, device="cpu")
    prefill, _, (p_shard,) = build_prefill_step(cfg, shape, run, local_mesh)
    place_model(stepped, p_shard, local_mesh, local=not as_dtensors)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, PROMPT + GEN)))
    with torch.no_grad():
        want_cache = plain.init_cache(2, PROMPT + GEN)
        want = [plain.prefill(toks[:, :PROMPT], want_cache)]
        for i in range(GEN):
            want.append(plain.decode_step(want_cache, toks[:, PROMPT + i],
                                          np.full(2, PROMPT + i)))
    got_logits, cache = prefill(stepped, {"tokens": toks[:, :PROMPT]})
    assert tp.rel_err(_full(got_logits), want[0]) < tp.TOL
    decode, _, _ = build_decode_step(cfg, ShapeConfig("d", PROMPT + GEN, 2, "decode"),
                                     local_mesh)
    cache = stepped.init_cache(2, PROMPT + GEN)
    with torch.no_grad(), dtensor_mode(stepped):
        stepped.prefill(toks[:, :PROMPT], cache)
    for i in range(GEN):
        logits, cache = decode(stepped, cache, toks[:, PROMPT + i], np.full(2, PROMPT + i))
        assert tp.rel_err(_full(logits), want[1 + i]) < tp.TOL, i
    # a step whose parameters are DTensors runs eagerly (models/decode_graph.py)
    reason = "parameters on a mesh" if as_dtensors else "cpu device"
    assert stepped.decode_graphs(cache).snapshot()["eager"] == {reason: GEN}


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def test_checkpoint_restores_onto_the_stated_placements(local_mesh, tmp_path):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    state = {"w": torch.randn(4, 6), "b": torch.arange(6, dtype=torch.float32).to(
        torch.bfloat16)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    pl = {"w": (local_mesh, (Shard(1), Replicate())), "b": (local_mesh, (Replicate(),
                                                                         Replicate()))}
    back, _ = ck.restore(1, state, shardings=pl)
    for k, t in back.items():
        assert isinstance(t, DTensor) and t.placements == pl[k][1], k
        assert t.dtype == state[k].dtype and torch.equal(t.full_tensor(), state[k]), k
    plain, _ = ck.restore(1, state)
    assert not isinstance(plain["w"], DTensor) and torch.equal(plain["w"], state["w"])
    ck.save(2, back)                 # a DTensor leaf is saved whole
    again, _ = ck.restore(2, state)
    assert torch.equal(again["w"], state["w"])


# ---------------------------------------------------------------------------
# kernel wrappers: meta paths and the DTensor boundary
# ---------------------------------------------------------------------------

def test_kernel_meta_paths_give_shapes_and_their_own_counts():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as ssd

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    q, k = meta(2, 64, 4, 32), meta(2, 64, 2, 32)
    with FlopCounterMode(display=False) as fc:
        out = fa.flash_attention_op(q, k, k, causal=True, window=16)
    assert out.shape == q.shape and out.device.type == "meta"
    assert fc.get_total_flops() == fa.flash_work(q.shape, k.shape, True, 16) == \
        4 * 32 * 2 * 4 * (16 * 17 // 2 + 48 * 16)
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention_op(qg, kg, kg, causal=True).sum().backward()
    assert fc.get_total_flops() == fa.flash_work(q.shape, k.shape, True, None) * 7 // 2
    assert qg.grad.shape == q.shape
    x, Bm, dt, A = meta(2, 64, 3, 16), meta(2, 64, 8), meta(2, 64, 3), meta(3)
    with FlopCounterMode(display=False) as fc:
        y, h = ssd.ssd_scan_op(x, Bm, Bm, dt, A, chunk=32, return_state=True)
    assert (y.shape, h.shape) == (x.shape, (2, 3, 8, 16))
    assert fc.get_total_flops() == ssd.ssd_work(2, 64, 3, 16, 8, 32)[1]
    ins = [t.clone().requires_grad_() for t in (x, Bm, Bm, dt, A)]
    with FlopCounterMode(display=False) as fc:
        ssd.ssd_scan_op(*ins, chunk=32).sum().backward()
    assert fc.get_total_flops() == ssd.ssd_work(2, 64, 3, 16, 8, 32, states=True)[1] + \
        ssd.ssd_bwd_work(2, 64, 3, 16, 8, 32)[1]
    assert [t.grad.shape for t in ins] == [t.shape for t in (x, Bm, Bm, dt, A)]
    pq, pool = meta(4, 8, 64, dtype=torch.bfloat16), meta(43, 16, 2, 2, 64, dtype=torch.bfloat16)
    plan = torch.zeros(4, 10, dtype=torch.int32, device="meta")
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        o = pa.paged_attention(pq, pool, None, lengths, plan=(plan, plan), live_blocks=3)
    assert o.shape == pq.shape and fc.get_total_flops() == 4 * 64 * 8 * (4 * 3 * 4 * 16)


def test_kernel_wrappers_refuse_dtensors(local_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    q = distribute_tensor(torch.randn(1, 8, 2, 32), local_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="plain tensors"):
        fa.flash_attention_op(q, q, q)
    x = distribute_tensor(torch.randn(1, 8, 2, 4), local_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="plain tensors"):
        ssd.ssd_scan_op(x, x[..., 0, :], x[..., 0, :], x[..., 0], x[0, 0, :, 0], chunk=8)


def test_kernel_custom_ops_take_meta_tensors_only():
    """The ops' bodies never run the kernel or its plain version: on CPU
    tensors they raise, and the wrappers keep the one CPU-or-launch dispatch."""
    import repro_torch.kernels.flash_attention.ops  # noqa: F401  (registers the ops)
    import repro_torch.kernels.paged_attention.ops  # noqa: F401
    import repro_torch.kernels.ssd_scan.ops  # noqa: F401
    ops = torch.ops.repro_torch
    q, x = torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 4)
    bm, i32 = torch.zeros(1, 8, 4), torch.zeros(1, 2, dtype=torch.int32)
    calls = [lambda: ops.flash_attention(q, q, q, True, 0, False),
             lambda: ops.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), q, True, 0),
             lambda: ops.paged_attention(torch.zeros(1, 2, 32), torch.zeros(4, 16, 2, 2, 32),
                                         i32, i32, torch.zeros(1, dtype=torch.int32), 1, 1),
             lambda: ops.ssd_scan(x, bm, bm, x[..., 0], x[0, 0, :, 0], 8, True, False),
             lambda: ops.ssd_scan_bwd(x, bm, bm, x[..., 0], x[0, 0, :, 0],
                                      torch.zeros(1, 1, 2, 4, 4), x, None, 8)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="meta tensors only"):
            call()


def test_serving_never_loads_dtensor():
    """Serving imports the DTensor boundary but never loads DTensor's module
    (some 500 modules, whose extra objects slow the engine's Python threads
    through longer collections): ``is_dtensor`` reads ``sys.modules``."""
    import os
    import subprocess
    import sys
    code = ("import sys, numpy as np, torch\n"
            "from repro_torch.configs import get_reduced\n"
            "from repro_torch.models import init_transformer\n"
            "for a in ('qwen1.5-0.5b', 'hymba-1.5b', 'deepseek-v2-lite-16b'):\n"
            "    m = init_transformer(get_reduced(a), seed=0, device='cpu')\n"
            "    c = m.init_cache(2, 16)\n"
            "    m.prefill(torch.zeros(2, 8, dtype=torch.long), c)\n"
            "    m.decode_step(c, torch.zeros(2, dtype=torch.long), np.array([8, 8]))\n"
            "print('torch.distributed.tensor' in sys.modules)\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "False"


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}
    port = ROOT / "src" / "repro_torch"
    for path in port.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                    else [])
            assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in mods), path


def test_mesh_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), fake) == (Shard(0), Shard(0), Shard(2))
    assert placements((), fake) == (Replicate(),) * 3

