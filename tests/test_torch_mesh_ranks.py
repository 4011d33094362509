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
