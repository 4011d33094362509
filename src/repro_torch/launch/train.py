"""End-to-end training launcher.

The port of ``repro/launch/train.py``: one loop of the train step
(forward, ``loss_fn``, backward through the flash-attention and SSD-scan
kernels, AdamW), the deterministic data pipeline, async crash-safe checkpointing
with resume-from-latest, and (``--offload``) the optimizer's first moment
streamed through the RDMAbox engine at every checkpoint — the paper's
remote paging system carrying real training state.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rdmabox-paper-100m \\
      --steps 200 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite-5l \\
      --steps 30 --batch 2 --seq 4096

``--arch`` takes any id of ``configs.ARCH_IDS`` or of ``configs.registry.STAGE_IDS``
(a published model cut to one pipeline stage: ``deepseek-v2-lite-5l``, the
published DeepSeek-V2-Lite's dense layer and first four MoE layers). After
its loop it prints the optimizer's counters (``adamw:``) and, for a MoE arch,
each MoE layer's routing over the run (``routing:``, ``routing_snapshot()``).

It runs on the card unless ``--device cpu`` is given (the kernels' plain
versions, as in the tests). Every arch trains on either device. The step is
built on ``make_local_mesh(--data, --model)``: the parameters are placed by
the sharding rules and the moments by ``optim_rules`` (ZeRO-1), and a
checkpoint restores onto those placements; the step runs on this device's
shards. One process is one rank, so the mesh is 1 × 1 and a larger one
fails with the count of devices this process sees. The default
``--ckpt-dir`` differs from the reference's, so the port never resumes a
JAX checkpoint.

``--offload`` sizes its donors to hold the whole first moment: the
reference's 3 donors of 1 << 16 pages hold 98,304 pages with replication
2, fewer than the 121,746 pages of rdmabox-paper-100m's f32 moment.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import box, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import RunConfig, get_config, get_reduced
from repro_torch.core.descriptors import PAGE_SIZE
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import build_train_step, place_model, shardings
from repro_torch.models import Transformer, init_transformer
from repro_torch.optim import adamw

OFFLOAD_DONORS, OFFLOAD_DONOR_PAGES, OFFLOAD_REPLICATION = 3, 1 << 16, 2


@dataclass
class TrainResult:
    model: Transformer
    opt_state: adamw.OptState
    start_step: int                # 0, or the step a checkpoint resumed from
    losses: np.ndarray             # one a step run, in order
    seconds: float                 # host clock from the first step's start to the last
                                   # step's end (a device sync), before its checkpoint
    first_step_s: float            # the first step alone (warm-up included)
    offload: Optional[Dict]        # the offload line's numbers, with --offload


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rdmabox-paper-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--offload", action="store_true",
                    help="stream checkpoints through the RDMAbox engine")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _offload_spec(tree: Dict[str, torch.Tensor]) -> box.ClusterSpec:
    """The reference's offload cluster, its donors grown to hold ``tree``
    (each tensor padded to whole pages) at its replication."""
    pages = sum(-(-t.numel() * t.element_size() // PAGE_SIZE) for t in tree.values())
    stripe = box.ClusterSpec().stripe_pages
    per_donor = -(-pages // (OFFLOAD_DONORS * stripe)) * stripe * OFFLOAD_REPLICATION
    return box.ClusterSpec(num_donors=OFFLOAD_DONORS, replication=OFFLOAD_REPLICATION,
                           donor_pages=max(OFFLOAD_DONOR_PAGES, per_donor))


def main(argv: Optional[List[str]] = None) -> TrainResult:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    run = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(10, args.steps // 10),
                    remat=args.remat, grad_compression=args.grad_compression,
                    checkpoint_dir=args.ckpt_dir,
                    checkpoint_every=args.ckpt_every)
    opened = not torch.distributed.is_initialized()
    mesh = make_local_mesh(args.data, args.model, device=device)
    try:
        return _train(args, cfg, run, device, mesh)
    finally:
        if opened:
            close_mesh()


def _train(args, cfg, run: RunConfig, device: torch.device, mesh) -> TrainResult:
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    train_step = build_train_step(cfg, run, mesh)
    model = init_transformer(cfg, seed=run.seed, device=device)
    p_shard, m_shard = shardings(cfg, model, mesh)
    place_model(model, p_shard, mesh, local=True)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt_state = adamw.init(params, run, shardings=m_shard, mesh=mesh)

    ckpt = Checkpointer(run.checkpoint_dir, keep=run.keep_checkpoints)
    start_step = 0
    moments = {n: (mesh, m_shard[n]) for n in params}
    restored = ckpt.restore_latest(
        (params, opt_state),
        ({n: (mesh, p_shard[n]) for n in params},
         adamw.OptState(None, moments, moments, moments if run.grad_compression else None)))
    if restored is not None:
        start_step, (saved, opt_state), extra = restored
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name].to_local())
        print(f"resumed from step {start_step}")
    opt_state = adamw.local_state(opt_state)

    offload_mgr = session = None
    if args.offload:
        session = box.open(_offload_spec(opt_state.m), device=device)
        offload_mgr = session.tensors()

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=run.seed))

    losses: List[torch.Tensor] = []
    offload = None
    adamw.reset()
    try:
        _sync(device)
        t0 = time.perf_counter()
        first_step_s = seconds = 0.0
        tokens_done = 0
        for step in range(start_step, args.steps):
            opt_state, metrics = train_step(model, opt_state, data.batch_at(step))
            losses.append(metrics["loss"])
            tokens_done += args.batch * args.seq
            if step in (start_step, args.steps - 1):
                _sync(device)
                seconds = time.perf_counter() - t0
                first_step_s = first_step_s or seconds
            if (step + 1) % args.log_every == 0 or step == start_step:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"tok/s {tokens_done/dt:,.0f}", flush=True)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss diverged at step {step + 1}: {loss}")
            if (step + 1) % run.checkpoint_every == 0:
                ckpt.save(step + 1, (params, opt_state),
                          extra={"data_step": step + 1}, blocking=False)
                if offload_mgr is not None:
                    offload_mgr.offload_tree("opt_m", opt_state.m, wait=False)
        print("adamw:", adamw.snapshot())
        if cfg.uses_moe:
            print("routing:", model.routing_snapshot())
        ckpt.wait()
        ckpt.save(args.steps, (params, opt_state),
                  extra={"data_step": args.steps})
        if offload_mgr is not None:
            offload_mgr.flush()
            st = session.stats()
            nic = st["nic"][str(session.clients[0])]
            merge = st["client"]["0"]["box"]["merge"]
            offload = {"rdma_ops": nic["rdma_ops"], "bytes_on_wire": nic["bytes_on_wire"],
                       "drains": merge["drains"], "submitted": merge["submitted"]}
            print(f"offload: {nic['rdma_ops']} RDMA ops, "
                  f"{nic['bytes_on_wire']/1e6:.1f} MB on wire, "
                  f"merge drains {merge['drains']} for "
                  f"{merge['submitted']} requests")
    finally:
        ckpt.wait()
        if session is not None:
            session.close()
    print("TRAINING DONE")
    return TrainResult(model, opt_state, start_step,
                       np.array([float(x) for x in losses]), seconds, first_step_s,
                       offload)


if __name__ == "__main__":
    main()
