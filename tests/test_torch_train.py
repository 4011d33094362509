"""The port's training loop end to end on the CPU, beside the reference's.

Twins of tests/test_system.py:46-77 on the port's ``build_train_step``
(reduced rdmabox-paper-100m, the reference's run settings): training
reduces the loss, grad compression still trains, a checkpoint resume is
bit-exact (10 straight steps against 5 + resume 5, ``torch.equal`` on every
parameter). A trajectory parity: 5 steps of the port and of the reference's
``build_train_step`` from the same bf16 weights on the same batches, the
losses within 1e-2 relative at every step and within 1e-3 at the first
(the bf16 updates round apart from step 2 on). ``launch.train`` and
``examples.train_lm`` run as a user runs them, with ``--offload`` and a
resume.

Not twinned here: test_spec_divisibility_fallback, test_optim_rules_shard_embed
and test_arch_overrides_apply (their twins are in tests/test_torch_sharding.py),
and test_hlo_analyzer_loop_flops_exact (XLA's HLO has no torch counterpart;
tests/test_torch_roofline.py holds the port's counter instead).
"""

import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

import torch_parity as tp  # noqa: E402
from repro.configs import RunConfig as RefRunConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as ref_build_train_step  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import RunConfig, get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import from_reference_params, init_transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "rdmabox-paper-100m"


def _train(steps, ckpt_dir=None, resume=False, grad_compression=False, sched_steps=20):
    """tests/test_system.py's ``_train`` on the port: (losses, model)."""
    cfg = get_reduced(ARCH)
    run = RunConfig(learning_rate=1e-3, total_steps=sched_steps, warmup_steps=2,
                    grad_compression=grad_compression)
    step_fn = build_train_step(cfg, run)
    model = init_transformer(cfg, seed=0, device="cpu").requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init(params, run)
    start = 0
    ckpt = Checkpointer(ckpt_dir, keep=2) if ckpt_dir else None
    if resume and ckpt:
        r = ckpt.restore_latest((params, opt))
        if r:
            start, (saved, opt), _ = r
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 128, 4))
    losses = []
    for step in range(start, steps):
        opt, m = step_fn(model, opt, data.batch_at(step))
        losses.append(float(m["loss"]))
        if ckpt and (step + 1) % 5 == 0:
            ckpt.save(step + 1, (params, opt))
    return losses, model


def test_training_reduces_loss():
    losses, _ = _train(20)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_grad_compression_still_trains():
    losses, _ = _train(15, grad_compression=True)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_checkpoint_resume_bitexact(tmp_path):
    """Crash/restart: resume must reproduce uninterrupted training."""
    _, full = _train(10, ckpt_dir=str(tmp_path / "a"))
    _train(5, ckpt_dir=str(tmp_path / "b"))                 # saves step 5
    _, resumed = _train(10, ckpt_dir=str(tmp_path / "b"), resume=True)
    for (name, a), b in zip(full.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name


def test_trajectory_matches_reference():
    cfg, params, _ = tp.models(ARCH)
    _, port_cfg = tp.reduced(ARCH)
    kw = dict(learning_rate=1e-3, total_steps=20, warmup_steps=2)
    ref_run, run = RefRunConfig(**kw), RunConfig(**kw)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 128, 4))
    model = from_reference_params(jax.tree.map(np.asarray, params), port_cfg,
                                  device="cpu").requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()), run)
    step_fn = build_train_step(port_cfg, run)
    mesh = make_local_mesh(1, 1)
    with jax.set_mesh(mesh):
        jitted, _, _ = ref_build_train_step(cfg, ref_run, mesh)
        ref_params, ref_opt = params, ref_adamw.init(params, ref_run)
        for step in range(5):
            batch = data.batch_at(step)
            ref_params, ref_opt, ref_m = jitted(ref_params, ref_opt, batch)
            opt, m = step_fn(model, opt, batch)
            want, got = float(ref_m["loss"]), float(m["loss"])
            tol = 1e-3 if step == 0 else 1e-2
            assert abs(got - want) <= tol * abs(want), f"step {step}: {got} vs {want}"


def _offload_ops(out: str) -> int:
    found = re.search(r"^offload: (\d+) RDMA ops, [\d.]+ MB on wire, merge drains \d+ "
                      r"for \d+ requests$", out, re.M)
    assert found, out
    return int(found.group(1))


@pytest.mark.parametrize("entry", ["launch.train", "examples.train_lm"])
def test_train_entry_points_run_and_resume(entry, tmp_path, capsys):
    main = train.main if entry == "launch.train" else train_lm.main
    args = ["--reduced", "--device", "cpu", "--steps", "6", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--log-every", "2"]
    if entry == "launch.train":
        args += ["--offload", "--batch", "4", "--seq", "64"]
    res = main(args)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("TRAINING DONE")
    assert out.startswith("arch=rdmabox-paper-reduced params≈")
    assert "mesh={'data': 1, 'model': 1}" in out.splitlines()[0]
    assert _offload_ops(out) > 0
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert Checkpointer(str(tmp_path / "ckpt")).steps() == [3, 6]
    again = main(args[:4] + ["8"] + args[5:])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out.splitlines()
    assert again.start_step == 6 and len(again.losses) == 2
    assert out.rstrip().endswith("TRAINING DONE")


def test_train_refuses_a_mesh(capsys, tmp_path):
    """One process is one rank: a mesh past 1 × 1 fails in make_local_mesh,
    naming the devices this process sees."""
    with pytest.raises(ValueError, match=r"needs 2 devices.*sees 1 cpu device"):
        train.main(["--reduced", "--device", "cpu", "--data", "2"])
    out = train.main(["--reduced", "--device", "cpu", "--data", "1", "--model", "1",
                      "--steps", "1", "--ckpt-every", "10", "--ckpt-dir", str(tmp_path),
                      "--log-every", "1"])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    assert np.isfinite(out.losses).all()
