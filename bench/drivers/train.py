"""Training steps: ``launch.steps.build_train_step`` on the 1 × 1 mesh, as
``launch/train.py`` builds and places it, AdamW with the mix's settings.

Set-up builds the one training object (the model with the seed's weights,
placed on the mesh; AdamW's state; the step) and drives it through its
first ``check_steps`` steps, the call and feed the window uses, each on
rows of its own drawn from the seed. Those steps give the check's
readings: each step's loss, every leaf's first gradient as the optimizer
got it (its first moment after one step over 1 − β₁) and every leaf's
change after the last of them. The window then runs more steps of the same
object until ``--seconds`` have passed on the host clock; ``train_tokens``
counts the tokens of every step in it.

The check follows the same steps with the reference from the same
weights and rows, in float32, AdamW rounding each parameter to bfloat16 as
the program stores it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from bench.lib import program
from bench.lib.harness import measure, release, sync


def batch(r, step: int):
    """Step ``step``'s (tokens, targets), (B, S) each, drawn on the device."""
    t, V = r.traffic, r.model["vocab_size"]
    gen = program.seeded(r.seed, 100 + step, r.device)
    rows = torch.randint(0, V, (t["batch"], t["seq"] + 1), generator=gen, device=r.device)
    return rows[:, :-1], rows[:, 1:]


def run(r) -> None:
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import close_mesh, make_local_mesh
    from repro_torch.launch.steps import build_train_step, place_model, shardings
    from repro_torch.optim import adamw
    t, dev = r.traffic, r.device
    opt = t["optimizer"]
    run_cfg = RunConfig(learning_rate=opt["lr"], warmup_steps=opt["warmup_steps"],
                        total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                        grad_clip=opt["grad_clip"])
    opened = not torch.distributed.is_initialized()
    mesh = make_local_mesh(1, 1, device=dev)
    try:
        w = program.weights(r)
        cfg, model = program.build(r, w)
        p_shard, m_shard = shardings(cfg, model, mesh)
        place_model(model, p_shard, mesh, local=True)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = adamw.local_state(adamw.init(params, run_cfg, shardings=m_shard, mesh=mesh))
        step_fn = build_train_step(cfg, run_cfg, mesh)
        n_done = 0

        def one_step() -> None:
            nonlocal state, n_done
            n_done += 1
            tokens, targets = batch(r, n_done)
            with record_function("bench.train_step"):
                state, metrics = step_fn(model, state, {"tokens": tokens, "targets": targets})
            losses.append(metrics["loss"])
            records.append(n_done)

        losses, records = [], []
        prog: Dict[str, Dict[str, float]] = {"grad": {}, "change": {}}
        for k in range(t["check_steps"]):
            one_step()
            if k == 0:
                b1 = opt["b1"]
                prog["grad"] = {n: float(mv.norm()) / (1 - b1) for n, mv in state.m.items()}
        with torch.no_grad():
            for g, _ in w.groups:
                for leaf, p0 in w.group(g).items():
                    n = w.full_name(g, leaf)
                    prog["change"][n] = float((params[n].float() - p0.float()).norm())
        prog["loss"] = [float(x) for x in losses]
        sync(dev)
        first = n_done
        measure(r, one_step, records, t["trace_steps"], t["trace_host_steps"])
        steps = n_done - first
        r.counts.update(train_tokens=steps * t["batch"] * t["seq"], attempted=steps, failed=0)
        r.notes["window_steps"] = steps
        r.notes["losses"] = prog["loss"]
        del model, params, state, step_fn, losses
        release(dev)
    finally:
        if opened:
            close_mesh()
    _check(r, w, prog)


def _check(r, w, prog) -> None:
    """The reference through the same steps: the largest gap of a step's loss,
    and, by the worst leaf, of a leaf's first-gradient norm and of its change's
    norm, each gap over the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out
    of the change."""
    ref = _reference(r, w, len(prog["loss"]), None)
    r.readings.update(_gaps(prog, ref))
    r.notes["worst_leaves"] = {k: _worst_leaf(prog[k], ref[k]) for k in ("grad", "change")}
    r.notes["ref_loss"] = ref["loss"]
    left_out = _left_out(ref)
    r.notes["leaves_left_out"] = sorted(left_out)[:8]
    r.notes["leaves_left_out_count"] = len(left_out)
    if r.control:                  # the reference in lower precision, in the program's place
        r.notes["control"] = _gaps(_reference(r, w, len(prog["loss"]), r.control), ref)


def _reference(r, w, steps: int, quant) -> Dict[str, object]:
    """{"loss": per step, "grad": leaf → first clipped gradient's norm,
    "change": leaf → norm of its change after ``steps``}."""
    ref, opt = r.reference, r.traffic["optimizer"]
    params = {}
    for g, _ in w.groups:
        for leaf, p in w.group(g).items():
            params[w.full_name(g, leaf)] = p.float().requires_grad_(True)
    state: dict = {}
    out: Dict[str, object] = {"loss": [], "grad": {}, "change": {}}
    with ref.exact_f32():
        for step in range(1, steps + 1):
            tokens, targets = batch(r, step)
            loss = ref.loss(params, r.model, tokens, targets, quant)
            grads = torch.autograd.grad(loss, list(params.values()))
            out["loss"].append(loss.item())
            clipped = ref.adamw_step(params, dict(zip(params, grads)), state, opt, step,
                                     torch.bfloat16)
            if step == 1:
                out["grad"] = {n: float(g.norm()) for n, g in clipped.items()}
            del grads, clipped
    with torch.no_grad():
        for g, _ in w.groups:
            for leaf, p0 in w.group(g).items():
                n = w.full_name(g, leaf)
                out["change"][n] = float((params[n] - p0.float()).norm())
    del params, state
    release(r.device)
    return out


def _left_out(ref) -> set:
    med = float(np.median(list(ref["grad"].values())))
    return {n for n, v in ref["grad"].items() if v < 1e-3 * med}


def _gaps(prog, ref) -> Dict[str, float]:
    moved = set(ref["grad"]) - _left_out(ref)
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": _worst(prog["grad"], ref["grad"]),
            "change_gap": _worst({n: prog["change"][n] for n in moved},
                                 {n: ref["change"][n] for n in moved})}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> str:
    med = float(np.median(list(ref.values())))
    return max(ref, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30))


def _worst(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    med = float(np.median(list(ref.values())))
    return max(abs(prog[n] - v) / max(v, med, 1e-30) for n, v in ref.items())
