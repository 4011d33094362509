"""The step builders on a real multi-rank mesh: every rank against the plain
model.

Four processes on the CPU form a 2×2 ("data", "model") mesh over ``gloo``
(one more case: 1×4, where a GQA arch's 2 KV heads are fewer than the model
axis's 4 shards and each shard reads the KV head its query heads need). The
parameters are DTensors placed by the sharding rules, the data DTensors
placed by ``batch_spec``; each rank runs ``build_prefill_step``, then
``build_decode_step`` with each sequence at its own position (so a rank
that plans another rank's sequences would read the wrong ones), then one
``build_train_step`` with ZeRO-1 moments. Every rank's logits (gathered),
loss and first moments (the gradients, gathered) are held against the
plain ``Transformer`` on the same weights and data, in f32.

This is the path the dry run counts on the fake production meshes; here it
runs with real collectives and real values on every rank.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

B, S, STEPS = 4, 32, 3
LOGIT_TOL = 1e-5      # max|a − b| / max(|b|, 1), f32 on both sides
GRAD_TOL = 1e-4       # ‖m_mesh − m_plain‖ / ‖m_plain‖ per parameter


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _run(arch: str, shape, rank: int, port: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.distributed.sharding import batch_spec, distribute, placements
    from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                          build_train_step, place_model, shardings)
    from repro_torch.models import init_transformer
    from repro_torch.optim import adamw
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=shape[0] * shape[1])
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cfg, run = get_reduced(arch), RunConfig(remat="none")
        L = S + STEPS + B
        plain = init_transformer(cfg, seed=0, device="cpu").float()
        model = init_transformer(cfg, seed=0, device="cpu").float()
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).int()
        pl = placements(batch_spec(mesh, B), mesh)
        out = {}

        prefill, _, (p_shard,) = build_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"),
                                                    run, mesh)
        place_model(model, p_shard, mesh, local=False)
        logits, _ = prefill(model, {"tokens": distribute(toks[:, :S], mesh, pl)})
        with torch.no_grad():
            want = plain.prefill(toks[:, :S], plain.init_cache(B, S))
        out["prefill"] = _rel(_full(logits), want)

        # decode: a cache of L positions filled by the step's own prefill, then
        # each sequence b decodes at position S + i + b
        decode, _, _ = build_decode_step(cfg, ShapeConfig("d", L, B, "decode"), mesh)
        with torch.no_grad():
            from repro_torch.launch.steps import _inputs, dtensor_mode
            with dtensor_mode(model):
                cache = model.init_cache(B, L)
                model.prefill(*_inputs(model, distribute(toks[:, :S], mesh, pl)), cache)
            plain_cache = plain.init_cache(B, L)
            plain.prefill(toks[:, :S], plain_cache)
        errs = []
        for i in range(STEPS):
            cur = S + i + np.arange(B)
            got, cache = decode(model, cache, distribute(toks[:, S + i], mesh, pl), cur)
            with torch.no_grad():
                want = plain.decode_step(plain_cache, toks[:, S + i].long(), cur)
            errs.append(_rel(_full(got), want))
        out["decode"] = max(errs)

        targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).int()
        _, m_shard = shardings(cfg, model, mesh)
        model.requires_grad_(True)
        plain.requires_grad_(True)
        opt = adamw.init(dict(model.named_parameters()), run, shardings=m_shard, mesh=mesh)
        opt, metrics = build_train_step(cfg, run, mesh)(
            model, opt, {"tokens": distribute(toks[:, :S], mesh, pl),
                         "targets": distribute(targets, mesh, pl)})
        p_opt = adamw.init(dict(plain.named_parameters()), run)
        p_opt, p_metrics = build_train_step(cfg, run)(
            plain, p_opt, {"tokens": toks[:, :S], "targets": targets})
        out["loss"] = abs(float(_full(metrics["loss"])) - float(p_metrics["loss"]))
        out["grads"] = {n: ((_full(m) - p_opt.m[n]).norm()
                            / p_opt.m[n].norm().clamp(min=1e-30)).item()
                        for n, m in opt.m.items()}
        return out
    finally:
        dist.destroy_process_group()


def _worker(arch, shape, rank, port, queue):
    torch.set_num_threads(1)
    try:
        queue.put((rank, _run(arch, shape, rank, port)))
    except BaseException:   # noqa: BLE001 — report it to the parent
        import traceback
        queue.put((rank, traceback.format_exc()))


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-32b", (2, 2)),          # GQA 4/2, heads and batch split
    ("qwen2.5-32b", (1, 4)),          # 2 KV heads over 4 shards: sliced per shard
    ("mamba2-780m", (2, 2)),          # the scan and the SSM state
    ("hymba-1.5b", (2, 2)),           # the ring and the SSM state together
    ("deepseek-v2-lite-16b", (2, 2)),  # MLA's latent cache, MoE
    ("qwen2-moe-a2.7b", (2, 2)),      # MoE with shared experts
])
def test_every_rank_matches_the_plain_model(arch, shape):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(arch, shape, r, port, queue))
             for r in range(shape[0] * shape[1])]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, res in sorted(results.items()):
        assert isinstance(res, dict), f"rank {rank}:\n{res}"
        assert res["prefill"] < LOGIT_TOL and res["decode"] < LOGIT_TOL, (rank, res)
        assert res["loss"] < 1e-5, (rank, res["loss"])
        bad = {n: e for n, e in res["grads"].items() if not e < GRAD_TOL}
        assert not bad, (rank, bad)


# ---------------------------------------------------------------------------
# the perf knobs on the 2×2 mesh, against the reference's shard_map
# ---------------------------------------------------------------------------
#
# The reference runs on a 2×2 mesh of 4 forced host devices in a process of
# its own (as tests/test_torch_roofline.py's reference_16x16): its reduced
# config under the knob, f32 weights from init_stack, (B 4, S 16) tokens. It
# writes its weights and results; the four gloo ranks load the same weights
# and hold theirs to them. moe: qwen2-moe (6 experts over 2 model shards do
# not divide under its rules, so TP on moe_ff 64) and deepseek (8 experts: EP,
# 4 a shard), and deepseek at capacity factor 0.25, where each shard's
# capacity from its own 32 tokens drops pairs; mla_lat: deepseek's decode from
# an empty f32 cache, S steps.
#
# The reference runs its shard_map with JAX's varying-axes check off
# (``check_vma=False``; its code unchanged). With the check on (JAX 0.9's
# default) its EP gradients are wrong: on the same function (no pair dropped,
# no aux loss) they differ from its own global dispatch's by 25-91 %
# (tools/moe_ep_grad_check.py), while the TP layout's and the port's agree
# to 1e-6. ROADMAP §3.

KNOB_CASES = {   # case: (arch, knobs, config overrides)
    "moe_tp": ("qwen2-moe-a2.7b", ["moe"], {}),
    "moe_ep": ("deepseek-v2-lite-16b", ["moe"], {}),
    "moe_ep_drops": ("deepseek-v2-lite-16b", ["moe"], {"capacity_factor": 0.25}),
    "mla_lat": ("deepseek-v2-lite-16b", ["mla_lat"], {}),
}
KB, KS = 4, 16
AUX_TOL = 1e-5        # |aux_a − aux_b| / max(|aux_b|, 1e-30)

_REFERENCE_2x2 = """
import dataclasses, functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
from repro.configs import get_reduced
from repro.configs.optimized import optimize
from repro.launch.mesh import make_local_mesh
from repro.models import decode_step, forward, init_cache, init_stack, loss_fn
cases, B, S, out = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
mesh = make_local_mesh(2, 2)
rng = np.random.default_rng(0)
for case, (arch, knobs, over) in cases.items():
    base = dataclasses.replace(get_reduced(arch), **over)
    cfg = optimize(base, only=set(knobs))
    params, _ = init_stack(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    res = {"tokens": tokens, "targets": targets}
    flat = {}
    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params, "")
    np.savez(f"{out}/{case}_params.npz", **flat)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, y, c: loss_fn(p, t, y, c), has_aux=True), static_argnums=3)
    with jax.set_mesh(mesh):
        logits, aux = jax.jit(lambda p, t: forward(p, t, cfg))(params, jnp.asarray(tokens))
        (loss, _), grads = grad_fn(params, jnp.asarray(tokens), jnp.asarray(targets), cfg)
        res.update(logits=np.asarray(logits), aux=np.asarray(aux), loss=np.asarray(loss))
        if "moe" in knobs:    # the same step with the global dispatch
            (loss_g, _), _ = grad_fn(params, jnp.asarray(tokens), jnp.asarray(targets), base)
            res["loss_global"] = np.asarray(loss_g)
        if "mla_lat" in knobs:
            step = jax.jit(lambda p, c, t, i: decode_step(p, c, t, i, cfg))
            cache = init_cache(cfg, B, S, dtype=jnp.float32)
            steps = []
            for t in range(S):
                lg, cache = step(params, cache, jnp.asarray(tokens[:, t]),
                                 jnp.full((B,), t, jnp.int32))
                steps.append(np.asarray(lg))
            res["decode"] = np.stack(steps, 1)
    flat = {}
    walk(grads, "grad.")
    res.update(flat)
    np.savez(f"{out}/{case}_ref.npz", **res)
print("ok")
"""


@pytest.fixture(scope="module")
def reference_2x2(tmp_path_factory):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    out = tmp_path_factory.mktemp("ref2x2")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    got = subprocess.run([sys.executable, "-c", _REFERENCE_2x2, json.dumps(KNOB_CASES),
                          str(KB), str(KS), str(out)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return out


def _run_knob(case: str, ref_dir: str, rank: int, port: int) -> dict:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.configs.optimized import optimize
    from repro_torch.distributed.sharding import batch_spec, distribute, placements
    from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                          dtensor_mode, place_model)
    from repro_torch.models import from_reference_params, loss_fn
    arch, knobs, over = KNOB_CASES[case]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = optimize(dataclasses.replace(get_reduced(arch), **over), only=set(knobs))
        ref = dict(np.load(f"{ref_dir}/{case}_ref.npz"))
        model = from_reference_params(dict(np.load(f"{ref_dir}/{case}_params.npz")), cfg,
                                      device="cpu", dtype=torch.float32)
        _, _, (p_shard,) = build_prefill_step(cfg, ShapeConfig("p", KS, KB, "prefill"),
                                              RunConfig(remat="none"), mesh)
        place_model(model, p_shard, mesh, local=False)
        pl = placements(batch_spec(mesh, KB), mesh)
        tokens = distribute(torch.from_numpy(ref["tokens"]).long(), mesh, pl)
        targets = distribute(torch.from_numpy(ref["targets"]).long(), mesh, pl)
        out = {}
        if "moe" in knobs:
            with torch.no_grad(), dtensor_mode(model):
                logits, aux = model.forward_train(tokens)
            out["logits"] = _rel(_full(logits), torch.from_numpy(ref["logits"]))
            out["aux"] = abs(float(_full(aux)) - float(ref["aux"])) / max(
                abs(float(ref["aux"])), 1e-30)
            model.requires_grad_(True)
            with dtensor_mode(model):
                loss, _ = loss_fn(model, tokens, targets)
                loss.backward()
            out["loss"] = abs(float(_full(loss.detach())) - float(ref["loss"]))
            out["loss_vs_global"] = abs(float(ref["loss_global"]) - float(ref["loss"]))
            grads = {}
            for name, p in model.named_parameters():
                parts = name.split(".")
                key = ".".join(["grad.blocks", *parts[2:]]) if parts[0] == "blocks" \
                    else "grad." + name
                want = torch.from_numpy(ref[key][int(parts[1])] if parts[0] == "blocks"
                                        else ref[key])
                got = _full(p.grad) if p.grad is not None else torch.zeros_like(want)
                grads[name] = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
            out["grads"] = grads
        if "mla_lat" in knobs:
            decode, _, _ = build_decode_step(cfg, ShapeConfig("d", KS, KB, "decode"), mesh)
            with torch.no_grad(), dtensor_mode(model):
                cache = model.init_cache(KB, KS)
            errs = []
            for t in range(KS):
                got, cache = decode(model, cache, tokens[:, t], np.full(KB, t))
                errs.append(_rel(_full(got), torch.from_numpy(ref["decode"][:, t])))
            out["decode"] = max(errs)
        return out
    finally:
        dist.destroy_process_group()


def _knob_worker(case, ref_dir, rank, port, queue):
    torch.set_num_threads(1)
    try:
        queue.put((rank, _run_knob(case, ref_dir, rank, port)))
    except BaseException:   # noqa: BLE001 — report it to the parent
        import traceback
        queue.put((rank, traceback.format_exc()))


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_knob_on_every_rank_matches_the_references_shard_map(case, reference_2x2):
    """Every rank's logits, aux and loss (1e-5) and every parameter's gradient
    (1e-4) under ``moe``, and every decode step's logits under ``mla_lat``
    (1e-5), against the reference's on the same 2×2 mesh; with drops, the
    reference's per-shard capacity gives another loss than its global
    dispatch, so the port's matching it is the per-shard rule."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_knob_worker, args=(case, str(reference_2x2), r, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, res in sorted(results.items()):
        assert isinstance(res, dict), f"rank {rank}:\n{res}"
        if "grads" in res:
            assert res["logits"] < LOGIT_TOL and res["aux"] < AUX_TOL, (rank, res)
            assert res["loss"] < 1e-5, (rank, res["loss"])
            bad = {n: e for n, e in res["grads"].items() if not e < GRAD_TOL}
            assert not bad, (rank, bad)
            if case == "moe_ep_drops":
                assert res["loss_vs_global"] > 100 * 1e-5, res["loss_vs_global"]
        if "decode" in res:
            assert res["decode"] < LOGIT_TOL, (rank, res["decode"])
