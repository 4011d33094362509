"""The port's AdamW, data pipeline and checkpointer against the reference.

The same numpy gradients go to both packages' ``lr_schedule``,
``clip_by_global_norm``, ``compress_grads`` and ``update`` (with and
without compression): they agree to 1e-6. ``SyntheticTokens.batch_at`` is
array-equal to the reference's. Twins of tests/test_system.py's optimizer,
data and checkpoint cases: ``test_adamw_converges_quadratic``,
``test_grad_compression_error_feedback``,
``test_data_deterministic_and_masked``, ``test_checkpoint_gc_keeps_n`` and
``test_checkpoint_restores_dtypes``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro.configs import RunConfig as RefRunConfig  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as RefSyntheticTokens  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = 1e-6
# ndim 1, 2 and 3: weight decay goes on the matrices only
SHAPES = {"norm": (16,), "w": (16, 24), "experts": (3, 8, 12)}


def grads_np(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.normal(size=s)).astype(np.float32) for n, s in SHAPES.items()}


def close(a, b, tol=TOL) -> None:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol, rtol=tol)


def test_run_config_is_the_reference_s():
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(RefRunConfig())


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    run = RunConfig(learning_rate=1e-3, total_steps=100, warmup_steps=10)
    ref = RefRunConfig(learning_rate=1e-3, total_steps=100, warmup_steps=10)
    want = float(ref_adamw.lr_schedule(jnp.asarray(step, jnp.int32), ref))
    assert abs(adamw.lr_schedule(step, run) - want) <= TOL * max(abs(want), 1e-3)


def both(g: dict, dtype: str) -> tuple:
    """The same gradients as torch tensors and JAX arrays of ``dtype``
    (bf16 rounds the same way in both)."""
    ours = {n: torch.from_numpy(a).to(getattr(torch, dtype)) for n, a in g.items()}
    return ours, {n: jnp.asarray(a, getattr(jnp, dtype)) for n, a in g.items()}


# bf16 gradients: both clip in f32 (the reference's bf16 * f32 scale promotes),
# so a clipped bf16 gradient is not rounded to bf16 before the moments see it
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 100.0])   # clipped, and not
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    ours, theirs = both(grads_np(1), dtype)
    out, gn = adamw.clip_by_global_norm(ours, max_norm)
    ref_out, ref_gn = ref_adamw.clip_by_global_norm(theirs, max_norm)
    close(gn, ref_gn)
    for n in ours:
        assert out[n].dtype == torch.float32
        close(out[n], ref_out[n])


def test_compress_grads_matches_reference():
    g, e = grads_np(2), grads_np(3, scale=0.01)
    deq, err = adamw.compress_grads({n: torch.from_numpy(a) for n, a in g.items()},
                                    {n: torch.from_numpy(a) for n, a in e.items()})
    ref_deq, ref_err = ref_adamw.compress_grads({n: jnp.asarray(a) for n, a in g.items()},
                                                {n: jnp.asarray(a) for n, a in e.items()})
    for n in g:
        close(deq[n], ref_deq[n])
        close(err[n], ref_err[n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])    # the gradients'
@pytest.mark.parametrize("compression", [False, True])
def test_update_matches_reference(compression, dtype):
    run = RunConfig(learning_rate=1e-2, total_steps=50, warmup_steps=2,
                    grad_compression=compression)
    ref_run = RefRunConfig(learning_rate=1e-2, total_steps=50, warmup_steps=2,
                           grad_compression=compression)
    p0 = grads_np(4)
    params = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    ref_params = {n: jnp.asarray(a) for n, a in p0.items()}
    state, ref_state = adamw.init(params, run), ref_adamw.init(ref_params, ref_run)
    for step in range(3):               # moments, bias corrections and residual carried
        ours, theirs = both(grads_np(10 + step), dtype)
        state, m = adamw.update(ours, state, params, run)
        ref_params, ref_state, ref_m = ref_adamw.update(theirs, ref_state, ref_params, ref_run)
        assert int(state.step) == int(ref_state.step) == step + 1
        close(m["grad_norm"], ref_m["grad_norm"])
        assert abs(m["lr"] - float(ref_m["lr"])) <= TOL * float(ref_m["lr"])
        for n in p0:
            close(params[n], ref_params[n])
            close(state.m[n], ref_state.m[n])
            close(state.v[n], ref_state.v[n])
            if compression:
                close(state.err[n], ref_state.err[n])
    assert (state.err is None) == (not compression)


def test_update_keeps_each_parameter_s_dtype_in_place():
    run = RunConfig(learning_rate=1e-2, total_steps=10, warmup_steps=1)
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    ids = {n: p.data_ptr() for n, p in params.items()}
    state = adamw.init(params, run)
    old_m = state.m["w"]
    new, _ = adamw.update({n: torch.ones_like(p) for n, p in params.items()}, state,
                          params, run)
    assert params["w"].dtype == torch.bfloat16 and params["w"].lt(1).all()
    assert {n: p.data_ptr() for n, p in params.items()} == ids
    assert new.m["w"] is not old_m and float(old_m.abs().sum()) == 0.0


@pytest.fixture
def local_mesh():
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.close_mesh()
    yield mesh_mod.make_local_mesh(1, 1, device="cpu")
    mesh_mod.close_mesh()


def test_update_takes_the_plain_loop_off_the_card_and_says_why(local_mesh):
    """Leaves off the card never reach the kernel: CPU tensors and the dry
    run's meta tensors, DTensors on a mesh or not. Each step goes through the
    plain loop, counted in ``snapshot()`` with its reason, and launches
    nothing."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import distribute
    run = RunConfig(learning_rate=1e-2, total_steps=10, warmup_steps=1)

    def leaves(device):
        return {n: torch.ones(s, device=device) for n, s in SHAPES.items()}

    replicated = {n: (Replicate(), Replicate()) for n in SHAPES}
    on_mesh = dict(shardings=replicated, mesh=local_mesh)

    def placed(device):
        return {n: distribute(t, local_mesh, replicated[n]) for n, t in leaves(device).items()}

    cpu_dtensors = placed("cpu")
    cases = [("cpu tensors", leaves("cpu"), {}), ("meta tensors", leaves("meta"), {}),
             ("cpu tensors", cpu_dtensors, on_mesh), ("meta tensors", placed("meta"), on_mesh)]
    adamw.reset()
    for k, (reason, params, placing) in enumerate(cases, start=1):
        grads = {n: torch.ones_like(p) for n, p in params.items()}
        adamw.update(grads, adamw.init(params, run, **placing), params, run)
        assert adamw.snapshot() == {"fused_steps": 0, "plain_steps": k,
                                    "plain_reason": reason, "launches": 0}
    assert all(p.to_local().lt(1).all() for p in cpu_dtensors.values())   # stepped in place
    adamw.reset()
    assert adamw.snapshot() == {"fused_steps": 0, "plain_steps": 0, "plain_reason": None,
                                "launches": 0}


def test_adamw_converges_quadratic():
    """Twin of tests/test_system.py::test_adamw_converges_quadratic."""
    run = RunConfig(learning_rate=0.1, total_steps=100, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.ones(8) * 5}
    state = adamw.init(params, run)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}          # d/dw w²
        state, _ = adamw.update(grads, state, params, run)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_compression_error_feedback():
    """Twin of tests/test_system.py::test_grad_compression_error_feedback."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=512).astype(np.float32))}
    deq, new_err = adamw.compress_grads(g, {"w": torch.zeros(512)})
    scale = float(g["w"].abs().max()) / 127
    assert float(new_err["w"].abs().max()) <= scale
    np.testing.assert_allclose((deq["w"] + new_err["w"]).numpy(), g["w"].numpy(), atol=1e-6)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123)])
def test_batches_equal_the_reference_s(seed, step):
    cfg = dict(vocab_size=1000, seq_len=300, global_batch=3, seed=seed)
    ours = SyntheticTokens(DataConfig(**cfg)).batch_at(step)
    want = RefSyntheticTokens(RefDataConfig(**cfg)).batch_at(step)
    assert ours.keys() == want.keys()
    for k in want:
        assert ours[k].dtype == want[k].dtype
        np.testing.assert_array_equal(ours[k], want[k])


def test_data_deterministic_and_masked():
    """Twin of tests/test_system.py::test_data_deterministic_and_masked."""
    d = SyntheticTokens(DataConfig(1000, 64, 4, seed=3))
    a, b = d.batch_at(7), d.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert (a["targets"] == -100).any()
    assert a["tokens"].max() < 1000
    c = d.batch_at(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_checkpoint_gc_keeps_n(tmp_path):
    """Twin of tests/test_system.py::test_checkpoint_gc_keeps_n."""
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"w": torch.ones(4, 4)}
    for s in (1, 2, 3, 4):
        ck.save(s, state, blocking=s % 2 == 0)
    ck.wait()
    assert ck.steps() == [3, 4]


def test_checkpoint_restores_dtypes(tmp_path):
    """Twin of tests/test_system.py::test_checkpoint_restores_dtypes; with an
    ``OptState`` (a NamedTuple with a None) inside."""
    ck = Checkpointer(str(tmp_path))
    params = {"bf": torch.ones(3, dtype=torch.bfloat16) * 1.5,
              "f32": torch.ones(3) * 2, "i32": torch.arange(3, dtype=torch.int32),
              "i64": torch.arange(3)}
    opt = adamw.init(params, RunConfig())._replace(step=torch.tensor(7, dtype=torch.int32))
    ck.save(1, (params, opt), extra={"data_step": 1})
    like = ({n: torch.zeros_like(p) for n, p in params.items()},
            adamw.init(params, RunConfig()))
    (back, back_opt), extra = ck.restore(1, like)
    assert extra == {"data_step": 1}
    for n, p in params.items():
        assert back[n].dtype == p.dtype and torch.equal(back[n], p)
    assert isinstance(back_opt, adamw.OptState) and back_opt.err is None
    assert int(back_opt.step) == 7 and back_opt.step.dtype == torch.int32
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(1, ({"bf": params["bf"]}, like[1]))
