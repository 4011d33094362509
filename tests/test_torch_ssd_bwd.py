"""The SSD scan backward: the port's gradients against JAX's.

At small shapes with several chunks (chunk < L, N ≠ P), on the same inputs
made from a seed with numpy, the plain backward ``ssd_scan_bwd_ref`` (the
backward kernel's plain version: an explicit reverse sweep over the chunks,
not autograd) agrees in f32 to max|a − b| / max(|b|, 1) ≤ 1e-4 with:

- ``jax.vjp`` of the reference's ``ssd_ref`` (the sequential recurrence; the
  reference trains through autodiff of its plain scan, it has no backward
  kernel), for y's cotangent;
- ``torch.autograd`` through the port's ``ssd_chunked``, for y's and
  h_final's cotangents (``ssd_ref`` does not return h_final).

The training forward sums cs in f64 (``ssd_chunked(..., cs64=True)``, and
the kernel's training instance), as the backward does. On the CPU
``ssd_scan_op`` goes through the ``autograd.Function`` whose backward is
that plain version. The card's cases (marked ``gpu`` in their
names; they skip without one) hold the CUDA backward to it, bit-equal across
runs, and count its launches. JAX is imported only by the cases that use it,
so on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_ssd_bwd.py -k gpu
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_bwd_ref  # noqa: E402

# f32 on both sides, the same function summed in other orders; the plain
# backward sums cs, dcs and dA in f64, the others in f32
BWD_TOL = 1e-4
SHAPES = [   # B, L, H, P, N, chunk: several chunks each, N ≠ P
    (2, 64, 3, 8, 5, 16),
    (1, 96, 2, 12, 6, 32),
    (2, 128, 2, 16, 8, 64),
    (1, 48, 4, 4, 10, 8),
]
GPU_SHAPES = SHAPES + [   # + ragged tiles, two row blocks, the full widths
    (1, 21, 2, 5, 3, 7),
    (2, 200, 2, 33, 70, 100),
    (1, 512, 3, 64, 128, 256),   # mamba2-780m's state and head sizes
    (1, 512, 3, 64, 16, 256),    # hymba-1.5b's N 16
]
GRADS = ("dx", "dB", "dC", "ddt", "dA")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def inputs(shape, seed=0):
    """x, Bm, Cm, dt, A as mamba2's mixer makes them (dt = softplus(·),
    A = −exp(·)), y's cotangent dy and h_final's dh, f32 numpy."""
    B, L, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)) * 0.5
    Bm, Cm = rng.normal(size=(B, L, N)) * 0.5, rng.normal(size=(B, L, N)) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H))))
    A = -np.exp(rng.random(H) * 1.5)
    dy, dh = rng.normal(size=(B, L, H, P)), rng.normal(size=(B, H, N, P))
    return [a.astype(np.float32) for a in (x, Bm, Cm, dt, A, dy, dh)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,H,P,N,chunk", SHAPES)
def test_plain_backward_matches_jax_vjp(B, L, H, P, N, chunk):
    jax = pytest.importorskip("jax")
    from repro.kernels.ssd_scan.ref import ssd_ref
    x, Bm, Cm, dt, A, dy, _ = inputs((B, L, H, P, N, chunk))
    _, vjp = jax.vjp(ssd_ref, x, Bm, Cm, dt, A)
    want = [np.asarray(g) for g in vjp(dy)]
    tx = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A)]
    _, _, states = ssd_chunked(*tx, chunk=chunk, return_states=True, cs64=True)
    got = ssd_scan_bwd_ref(*tx, states, torch.from_numpy(dy), None, chunk=chunk)
    for name, g, w, t in zip(GRADS, got, want, tx):
        assert g.shape == t.shape and g.dtype == torch.float32
        assert rel(g, w) <= BWD_TOL, f"{name}: plain backward vs jax.vjp"


@pytest.mark.parametrize("B,L,H,P,N,chunk", SHAPES)
def test_plain_backward_matches_autograd_with_h_final_cotangent(B, L, H, P, N, chunk):
    x, Bm, Cm, dt, A, dy, dh = (torch.from_numpy(a) for a in inputs((B, L, H, P, N, chunk), 1))
    leaves = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, A)]
    y, h = ssd_chunked(*leaves, chunk=chunk, cs64=True)
    torch.autograd.backward([y, h], [dy, dh])
    _, _, states = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=True, cs64=True)
    got = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, dh, chunk=chunk)
    for name, g, leaf in zip(GRADS, got, leaves):
        assert rel(g, leaf.grad) <= BWD_TOL, f"{name}: plain backward vs torch autograd"


@pytest.mark.parametrize("cs64", [False, True])
def test_states_are_the_states_entering_each_chunk(cs64):
    x, Bm, Cm, dt, A = (torch.from_numpy(a) for a in inputs(SHAPES[0], 2)[:5])
    chunk = SHAPES[0][-1]
    y, h, states = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=True,
                               cs64=cs64)
    B, L, H, P = x.shape
    assert states.shape == (B, L // chunk, H, Bm.shape[-1], P)
    assert torch.equal(states[:, 0], torch.zeros_like(states[:, 0]))
    for c in range(1, L // chunk):
        _, h_c = ssd_chunked(*(t[:, :c * chunk] for t in (x, Bm, Cm, dt)), A, chunk=chunk,
                             cs64=cs64)
        torch.testing.assert_close(states[:, c], h_c, atol=1e-6, rtol=1e-6)
    assert torch.equal(ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, cs64=cs64)[0], y)


def test_cs64_only_sharpens_the_exponents():
    """The f64 sum of cs changes y by rounding only; the f32 default is
    serving's plain version, bit for bit what it was."""
    x, Bm, Cm, dt, A = (torch.from_numpy(a) for a in inputs((1, 512, 2, 16, 8, 256), 6)[:5])
    y32, h32 = ssd_chunked(x, Bm, Cm, dt, A, chunk=256)
    y64, h64 = ssd_chunked(x, Bm, Cm, dt, A, chunk=256, cs64=True)
    assert rel(y32, y64) <= 1e-4 and rel(h32, h64) <= 1e-4
    assert not torch.equal(y32, y64)


@pytest.mark.parametrize("B,L,H,P,N,chunk", SHAPES)
def test_ssd_op_backward_on_cpu_is_the_plain_backward(B, L, H, P, N, chunk):
    arrays = inputs((B, L, H, P, N, chunk), 3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    dy, dh = (torch.from_numpy(a) for a in arrays[5:])
    before = (ssd.launches, ssd.bwd_launches)
    y, h = ssd.ssd_scan_op(*leaves, chunk=chunk, return_state=True)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDScanBackward"
    torch.autograd.backward([y, h], [dy, dh])
    tx = [torch.from_numpy(a) for a in arrays[:5]]
    y_plain, h_plain, states = ssd_chunked(*tx, chunk=chunk, return_states=True, cs64=True)
    assert torch.equal(y.detach(), y_plain) and torch.equal(h.detach(), h_plain)
    plain = ssd_scan_bwd_ref(*tx, states, dy, dh, chunk=chunk)
    for leaf, p in zip(leaves, plain):
        assert torch.equal(leaf.grad, p)
    assert (ssd.launches, ssd.bwd_launches) == before      # the CPU launches no kernel


def test_ssd_op_backward_without_h_final_cotangent():
    """Training uses y alone: h_final's cotangent is absent, not zeros."""
    arrays = inputs(SHAPES[1], 4)
    chunk = SHAPES[1][-1]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    ssd.ssd_scan_op(*leaves, chunk=chunk).backward(torch.from_numpy(arrays[5]))
    tx = [torch.from_numpy(a) for a in arrays[:5]]
    _, _, states = ssd_chunked(*tx, chunk=chunk, return_states=True, cs64=True)
    plain = ssd_scan_bwd_ref(*tx, states, torch.from_numpy(arrays[5]), None, chunk=chunk)
    for leaf, p in zip(leaves, plain):
        assert torch.equal(leaf.grad, p)


def test_ssd_op_without_grad_builds_no_graph():
    arrays = inputs(SHAPES[0])
    chunk = SHAPES[0][-1]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    with torch.no_grad():
        assert ssd.ssd_scan_op(*leaves, chunk=chunk).grad_fn is None
    plain = [torch.from_numpy(a) for a in arrays[:5]]
    y, h = ssd.ssd_scan_op(*plain, chunk=chunk, return_state=True)
    assert y.grad_fn is None and h.grad_fn is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def test_ssd_backward_kernel_vs_plain_on_gpu(cuda):
    """The training forward (cs summed in f64: y, h_final and the chunk-entry
    states against the plain version's) and the backward kernel against
    ``ssd_scan_bwd_ref`` from the same states, with and without h_final's
    cotangent, run twice: equal bits, and no atomics to make them differ."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain side in true f32
    for i, shape in enumerate(GPU_SHAPES):
        chunk = shape[-1]
        x, Bm, Cm, dt, A, dy, dh = (torch.from_numpy(a).to(cuda) for a in inputs(shape, i))
        y, h, states = ssd._launch(x, Bm, Cm, dt, A, chunk, True, with_states=True)
        plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk, return_states=True, cs64=True)
        for got, want in zip((y, h, states), plain):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        for cot in (dh, None):
            got = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, chunk)
            again = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, chunk)
            want = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, cot, chunk=chunk)
            torch.cuda.synchronize()
            for name, a, b, w in zip(GRADS, got, again, want):
                assert torch.equal(a, b), f"{shape} {name}: two runs differ"
                assert rel(a.cpu(), w.cpu()) <= BWD_TOL, f"{shape} {name}"


def test_ssd_op_backward_launches_the_kernel_on_gpu(cuda):
    arrays = inputs(SHAPES[2], 5)
    chunk = SHAPES[2][-1]
    leaves = [torch.from_numpy(a).to(cuda).requires_grad_() for a in arrays[:5]]
    before = (ssd.launches, ssd.bwd_launches)
    y, h = ssd.ssd_scan_op(*leaves, chunk=chunk, return_state=True)
    torch.autograd.backward([y, h], [torch.from_numpy(a).to(cuda) for a in arrays[5:]])
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    with torch.no_grad():
        assert ssd.ssd_scan_op(*leaves, chunk=chunk).grad_fn is None
    assert ssd.bwd_launches == before[1] + 1
    with pytest.raises(TypeError):                 # f32 only, as the forward
        ssd.ssd_scan_op(leaves[0].double(), *leaves[1:], chunk=chunk)
