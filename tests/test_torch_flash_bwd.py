"""The flash attention backward: the port's gradients against JAX's.

At the reference suite's flash shapes (tests/test_kernels.py: GQA, a
window, Sq < Skv, D 32/64/128), on the same q, k, v and cotangent, three
gradients agree in f32 to max|a − b| / max(|b|, 1) ≤ 1e-5:

- ``jax.vjp`` of the reference's ``attention_ref`` (the reference trains
  through autodiff of plain attention; it has no backward kernel);
- the port's ``flash_attention_bwd_ref`` (the backward kernel's plain
  version: the explicit formula from the forward's output and LSE);
- ``torch.autograd`` through the port's ``attention_ref``.

On the CPU ``flash_attention_op`` goes through the ``autograd.Function``
whose backward is that plain version. The card's cases (marked ``gpu`` in
their names; they skip without one) hold the CUDA backward to it and check
the wrappers that must refuse a gradient. JAX is imported only by the cases
that use it, so on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_flash_bwd.py -k gpu
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_ref, flash_attention_online)

BWD_TOL = 1e-5        # f32: three sums of the same products in other orders
FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window (tests/test_kernels.py)
    (128, 128, 4, 2, 32, True, None),
    (128, 128, 4, 4, 64, False, None),
    (256, 256, 8, 2, 32, True, 96),
    (64, 192, 2, 2, 32, True, None),
    (64, 64, 2, 1, 128, True, None),
]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def inputs(shape, seed=0, B=2):
    Sq, Skv, H, Kh, D = shape[:5]
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, Sq, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, Kh, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window", FLASH_SHAPES)
def test_flash_backward_matches_jax_vjp(Sq, Skv, H, Kh, D, causal, window):
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention.ref import attention_ref as ref_attention
    q, k, v, do = inputs((Sq, Skv, H, Kh, D))
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(a, b, c, causal=causal, window=window),
                     q, k, v)
    want = [np.asarray(g) for g in vjp(do)]

    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_online(qt, kt, vt, causal=causal, window=window,
                                    q_offset=Skv - Sq, return_lse=True)
    plain = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=causal,
                                    window=window, q_offset=Skv - Sq)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    attention_ref(*leaves, causal=causal, window=window).backward(dot)
    for name, w, p, leaf in zip("qkv", want, plain, leaves):
        assert p.shape == leaf.shape and p.dtype == torch.float32
        assert rel(p, w) <= BWD_TOL, f"d{name}: plain backward vs jax.vjp"
        assert rel(leaf.grad, w) <= BWD_TOL, f"d{name}: torch autograd vs jax.vjp"


# The training paths of the 32-35 B archs and of MLA (chip_smoke.py's
# train_grads on the card): D 128 with GQA groups 5 (qwen2.5-32b, 40/8), 7
# (llava-next-34b, 56/8) and 8 (command-r-35b, 64/8), and MLA's attention at
# D 192 whose V is padded from 128 with zero columns (models/mla.py), the
# output's padded columns dropped (so their cotangent is zero), at small S.
ARCH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window, V columns (None: all D)
    (64, 64, 10, 2, 128, True, None, None),
    (64, 64, 14, 2, 128, True, None, None),
    (96, 96, 16, 2, 128, True, None, None),
    (64, 64, 4, 4, 192, True, None, 128),
]


def padded_v_inputs(shape, seed):
    """``inputs`` with V's and dO's columns past ``v_cols`` zero."""
    q, k, v, do = inputs(shape[:5], seed=seed)
    v_cols = shape[7]
    if v_cols is not None:
        v[..., v_cols:] = 0.0
        do[..., v_cols:] = 0.0
    return q, k, v, do


@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window,v_cols", ARCH_SHAPES)
def test_flash_backward_at_arch_groups_matches_jax_vjp(Sq, Skv, H, Kh, D, causal, window,
                                                       v_cols):
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention.ref import attention_ref as ref_attention
    q, k, v, do = padded_v_inputs((Sq, Skv, H, Kh, D, causal, window, v_cols), seed=5)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(a, b, c, causal=causal, window=window),
                     q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_online(qt, kt, vt, causal=causal, window=window,
                                    q_offset=Skv - Sq, return_lse=True)
    plain = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=causal,
                                    window=window, q_offset=Skv - Sq)
    for name, w, p in zip("qkv", want, plain):
        assert p.shape == w.shape and p.dtype == torch.float32
        assert rel(p, w) <= BWD_TOL, f"d{name}: plain backward vs jax.vjp"
    if v_cols is not None:   # nothing flows into the padding
        assert not plain[2][..., v_cols:].any() and not o[..., v_cols:].any()


@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window", FLASH_SHAPES)
def test_lse_is_logsumexp_of_masked_scores(Sq, Skv, H, Kh, D, causal, window):
    q, k, v, _ = inputs((Sq, Skv, H, Kh, D), seed=1)
    qt, kt, vt = (torch.from_numpy(x).double() for x in (q, k, v))
    # small tiles, so the online softmax carries its max across several
    _, lse = flash_attention_online(qt.float(), kt.float(), vt.float(), causal=causal,
                                    window=window, q_offset=Skv - Sq, q_block=32,
                                    kv_block=32, return_lse=True)
    G = H // Kh
    s = torch.einsum("bqhd,bthd->bhqt", qt, kt.repeat_interleave(G, dim=2)) * D ** -0.5
    qpos = torch.arange(Sq)[:, None] + Skv - Sq
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    assert (lse.double() - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window", FLASH_SHAPES)
def test_flash_op_backward_on_cpu_is_the_plain_backward(Sq, Skv, H, Kh, D, causal, window):
    q, k, v, do = inputs((Sq, Skv, H, Kh, D), seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = fa.bwd_launches
    out = fa.flash_attention_op(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_online(qt, kt, vt, causal=causal, window=window,
                                    q_offset=Skv - Sq, return_lse=True)
    plain = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=causal, window=window,
                                    q_offset=Skv - Sq)
    for leaf, p in zip(leaves, plain):
        assert torch.equal(leaf.grad, p)
    assert fa.bwd_launches == before          # the CPU launches no kernel


def test_flash_op_without_grad_builds_no_graph():
    q, k, v, _ = inputs(FLASH_SHAPES[0][:5])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert fa.flash_attention_op(*leaves).grad_fn is None
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    assert fa.flash_attention_op(*plain).grad_fn is None


def test_flash_bwd_ref_in_bf16_rounds_the_f32_result():
    q, k, v, do = inputs((64, 64, 4, 2, 64), seed=3)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    o, lse = flash_attention_online(*args[:3], return_lse=True)
    grads = flash_attention_bwd_ref(*args[:3], o, lse, args[3])
    f32 = flash_attention_bwd_ref(*(a.float() for a in args[:3]), o.float(), lse,
                                  args[3].float())
    for g, f in zip(grads, f32):
        assert g.dtype == torch.bfloat16 and torch.equal(g, f.bfloat16())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_SHAPES = [   # B, Sq, Skv, H, Kh, D, causal, window
    *[(2, *s) for s in FLASH_SHAPES],
    (8, 512, 512, 12, 4, 64, True, None),       # rdmabox-paper-100m's training shape
    (2, 100, 100, 6, 2, 64, True, None),        # ragged tiles
    (2, 64, 192, 4, 2, 64, True, None),         # Sq < Skv: dK/dV's first query block
    (1, 1280, 1280, 25, 5, 64, True, 1024),     # hymba's windowed shape
    (2, 70, 70, 16, 16, 128, False, 33),        # a window without causality
    (2, 64, 64, 16, 16, 192, True, None),       # MLA's head dim (deepseek)
    (1, 300, 300, 4, 4, 192, True, None),       # D 192, ragged tiles
]
GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the forward's FLASH_TOL

# The bf16 kernel's numerical budget, held on the CPU. The card's bf16
# backward rounds P and dS to bf16 before the tensor-core products that use
# them (dV = Pᵀ·dO; dQ = dS·K, dK = dSᵀ·q), sums in f32 and rounds each
# output once; its check holds it to the plain backward within GPU_TOL.
# These shapes are the card's: the training shape (at B 2), hymba's window,
# head dim 192, qwen1.5-0.5b's 16/16 heads and a ragged Sq < Skv.
ROUNDING_SHAPES = [   # B, Sq, Skv, H, Kh, D, causal, window
    (2, 512, 512, 12, 4, 64, True, None),
    (1, 1280, 1280, 25, 5, 64, True, 1024),
    (1, 512, 512, 16, 16, 192, True, None),
    (2, 512, 512, 16, 16, 64, True, None),
    (2, 100, 228, 4, 2, 64, True, None),
]


def bf16_kernel_roundings(q, k, v, o, lse, do, *, causal, window, q_offset):
    """The plain backward of one KV head group with the bf16 kernel's
    roundings: P rounded to bf16 before Pᵀ·dO, dS rounded to bf16 before
    dS·K and dSᵀ·q. q, o, do: (B, Sq, G, D); k, v: (B, Skv, 1, D); lse
    (B, G, Sq). Returns (dq, dk, dv) in the inputs' dtype."""
    D = q.shape[-1]
    scale = D ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = k[:, :, 0].float(), v[:, :, 0].float()
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq)[:, None] + q_offset
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.einsum("bqgd,btd->bgqt", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bgqt,bqgd->btd", p.bfloat16().float(), dof)
    dp = torch.einsum("bqgd,btd->bgqt", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)                      # (B, G, Sq)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dq = torch.einsum("bgqt,btd->bqgd", ds, kf) * scale
    dk = torch.einsum("bgqt,bqgd->btd", ds, qf) * scale
    return dq.to(q.dtype), dk[:, :, None].to(k.dtype), dv[:, :, None].to(v.dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,D,causal,window", ROUNDING_SHAPES)
def test_bf16_kernel_roundings_stay_within_the_card_tolerance(B, Sq, Skv, H, Kh, D, causal,
                                                              window):
    rng = np.random.default_rng(4)
    q, do = (torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Skv, Kh, D)).astype(np.float32)).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_online(q, k, v, causal=causal, window=window,
                                    q_offset=Skv - Sq, return_lse=True)
    G, tol, rounded = H // Kh, GPU_TOL[torch.bfloat16], False
    for kh in range(Kh):   # one KV head group at a time: a head group's work is separable
        heads = slice(kh * G, (kh + 1) * G)
        args = (q[:, :, heads], k[:, :, kh:kh + 1], v[:, :, kh:kh + 1], o[:, :, heads],
                lse[:, heads], do[:, :, heads])
        got = bf16_kernel_roundings(*args, causal=causal, window=window, q_offset=Skv - Sq)
        want = flash_attention_bwd_ref(*args, causal=causal, window=window,
                                       q_offset=Skv - Sq)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and a.dtype == w.dtype == torch.bfloat16
            torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol,
                                       msg=lambda m: f"d{name[1]}, KV head {kh}: {m}")
            rounded |= not torch.equal(a, w)
    assert rounded            # the roundings do change some bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_vs_plain_on_gpu(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, Sq, Skv, H, Kh, D, causal, window in GPU_SHAPES:
        q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
        k, v = (torch.randn(B, Skv, Kh, D, generator=g, device=cuda).to(dtype)
                for _ in range(2))
        do = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
        o, lse = fa._launch(q, k, v, causal, window, with_lse=True)
        assert torch.equal(o, fa._launch(q, k, v, causal, window))
        _, want_lse = flash_attention_online(q, k, v, causal=causal, window=window,
                                             q_offset=Skv - Sq, return_lse=True)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        got = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
        again = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                       q_offset=Skv - Sq)
        torch.cuda.synchronize()
        tol = GPU_TOL[dtype]
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b)              # no atomics: the same bits
            torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window,v_cols", ARCH_SHAPES)
def test_flash_backward_at_arch_groups_on_gpu(cuda, dtype, Sq, Skv, H, Kh, D, causal,
                                              window, v_cols):
    """ARCH_SHAPES through the CUDA backward against the plain one, twice with
    equal bits (chip_smoke.py holds the same groups at the training length)."""
    shape = (Sq, Skv, H, Kh, D, causal, window, v_cols)
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype)
                   for x in padded_v_inputs(shape, seed=6))
    o, lse = fa._launch(q, k, v, causal, window, with_lse=True)
    got = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
    again = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                   q_offset=Skv - Sq)
    torch.cuda.synchronize()
    tol = GPU_TOL[dtype]
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)


def test_flash_op_backward_launches_the_kernel_on_gpu(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=cuda, dtype=torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = (fa.launches, fa.bwd_launches)
    fa.flash_attention_op(q, k, v).sum().backward()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    with torch.no_grad():
        assert fa.flash_attention_op(q, k, v).grad_fn is None
    assert fa.bwd_launches == before[1] + 1


def test_wrappers_refuse_a_gradient_they_cannot_give_on_gpu(cuda):
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as ssd
    x = torch.randn(1, 32, 2, 16, device=cuda, requires_grad=True)
    Bm, Cm = torch.randn(1, 32, 8, device=cuda), torch.randn(1, 32, 8, device=cuda)
    dt, A = torch.rand(1, 32, 2, device=cuda), -torch.rand(2, device=cuda)
    # the scan refuses no longer: its gradient launches the backward kernel
    before = ssd.bwd_launches
    ssd.ssd_scan_op(x, Bm, Cm, dt, A, chunk=16).sum().backward()
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 1 and torch.isfinite(x.grad).all()
    with torch.no_grad():
        assert ssd.ssd_scan_op(x, Bm, Cm, dt, A, chunk=16).shape == x.shape
    q = torch.randn(1, 2, 32, device=cuda, requires_grad=True)
    pool = torch.randn(4, 8, 2, 2, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        pa.paged_attention(q, pool, np.array([[0, 1]], np.int32),
                           torch.tensor([12], device=cuda, dtype=torch.int32),
                           pages_per_block=2)
    qd = torch.randn(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="unsupported shapes"):   # no kernel at D 48
        fa.flash_attention_op(qd, qd.detach(), qd.detach())
