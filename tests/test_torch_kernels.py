"""repro_torch's kernels against the reference's oracles and Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held to the JAX oracle and to the Pallas kernel (interpret mode), on the
same inputs, at the reference suite's tolerances (tests/test_kernels.py).
The CUDA kernels themselves run only on a GPU: those cases skip here. JAX
is imported only by the cases that use it, so on a GPU machine without
JAX the card's cases still run:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_kernels.py -k gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_online)
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

DTYPES = ["float32", "bfloat16"]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # test_flash_vs_ref
PAGED_TOL = {"float32": 1e-5, "bfloat16": 3e-2}    # test_paged_attention_vs_ref

FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window, Pallas q_block, kv_block
    (128, 128, 4, 2, 32, True, None, 64, 64),
    (128, 128, 4, 4, 64, False, None, 32, 64),
    (256, 256, 8, 2, 32, True, 96, 64, 32),
    (64, 192, 2, 2, 32, True, None, 32, 32),
    (64, 64, 2, 1, 128, True, None, 64, 64),
]


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (needs JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention_op
    from repro.kernels.flash_attention.ref import attention_ref as flash_oracle
    from repro.kernels.paged_attention import ops as paged_ops
    from repro.kernels.paged_attention.ref import paged_attention_ref as paged_oracle
    return SimpleNamespace(jnp=jnp, flash=flash_attention_op, flash_oracle=flash_oracle,
                           paged=paged_ops, paged_oracle=paged_oracle)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def both(ref, rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 via f32, exact)."""
    j = ref.jnp.asarray(rng.normal(size=shape), getattr(ref.jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


def close(a, b, tol):
    a = a.float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window,qb,kb", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_vs_reference(ref, Sq, Skv, H, Kh, D, causal, window, qb, kb,
                                  dtype):
    rng = np.random.default_rng(Sq + Skv + H + D)
    qj, qt = both(ref, rng, (2, Sq, H, D), dtype)
    kj, kt = both(ref, rng, (2, Skv, Kh, D), dtype)
    vj, vt = both(ref, rng, (2, Skv, Kh, D), dtype)
    tol = FLASH_TOL[dtype]
    oracle = ref.flash_oracle(qj, kj, vj, causal=causal, window=window)
    pallas = ref.flash(qj, kj, vj, causal=causal, window=window, q_block=qb,
                       kv_block=kb)
    out = fa.flash_attention_op(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, Sq, H, D)
    close(out, oracle, tol)
    close(out, pallas, tol)
    close(attention_ref(qt, kt, vt, causal=causal, window=window), oracle, tol)
    # the online twin at the Pallas tiles, so its carry spans several tiles
    close(flash_attention_online(qt, kt, vt, causal=causal, window=window, q_block=qb,
                                 kv_block=kb, q_offset=Skv - Sq), oracle, tol)


def test_flash_rejects_empty_window():
    x = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError):
        fa.flash_attention_op(x, x, x, window=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_vs_plain_on_gpu(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for Sq, Skv, H, Kh, D, causal, window, _, _ in FLASH_SHAPES:
        q = torch.randn(2, Sq, H, D, generator=g, device=cuda).to(dtype)
        k = torch.randn(2, Skv, Kh, D, generator=g, device=cuda).to(dtype)
        v = torch.randn(2, Skv, Kh, D, generator=g, device=cuda).to(dtype)
        before = fa.launches
        out = fa.flash_attention_op(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        close(out, attention_ref(q, k, v, causal=causal, window=window), tol)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def random_table(rng, B, Pmax, P, contiguous):
    """The reference suite's tables: trailing −1 padding, no holes."""
    table = -np.ones((B, Pmax), np.int32)
    for b in range(B):
        n = rng.integers(1, Pmax + 1)
        if contiguous:
            start = rng.integers(0, P - n)
            table[b, :n] = np.arange(start, start + n)
        else:
            table[b, :n] = rng.choice(P, size=n, replace=False)
    return table


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("contig", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_vs_reference(ref, R, contig, dtype):
    B, H, Kh, D, T, P, Pmax = 3, 8, 4, 32, 8, 40, 6
    rng = np.random.default_rng(10 * R + contig)
    qj, qt = both(ref, rng, (B, H, D), dtype)
    kvj, kvt = both(ref, rng, (P, T, 2, Kh, D), dtype)
    table = random_table(rng, B, Pmax, P, contig)
    lengths = ((table >= 0).sum(1) * T - rng.integers(0, T, B)).astype(np.int32)
    tol = PAGED_TOL[dtype]
    jnp = ref.jnp
    oracle = ref.paged_oracle(qj, kvj, jnp.asarray(table), jnp.asarray(lengths))
    pallas = ref.paged.paged_attention(qj, kvj, table, jnp.asarray(lengths),
                                       pages_per_block=R)
    out = pa.paged_attention(qt, kvt, table, torch.from_numpy(lengths),
                             pages_per_block=R)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, D)
    close(out, oracle, tol)
    close(out, pallas, tol)
    close(paged_attention_ref(qt, kvt, torch.from_numpy(table),
                              torch.from_numpy(lengths)), oracle, tol)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_planner_matches_reference(ref, R):
    rng = np.random.default_rng(R)
    for contig in (True, False):
        for _ in range(5):
            table = random_table(rng, 4, 9, 64, contig)
            for ours, theirs in zip(pa.plan_blocks(table, R),
                                    ref.paged.plan_blocks(table, R)):
                np.testing.assert_array_equal(ours, theirs)
            assert pa.descriptor_stats(table, R) == ref.paged.descriptor_stats(table, R)


def test_planner_coalesces_contiguous():
    table = np.array([[0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    stats = pa.descriptor_stats(table, 4)
    assert stats["descriptors"] == 2 and stats["reduction"] == 4.0


def test_planner_fragmented_degrades_gracefully():
    table = np.array([[0, 2, 4, 6, 8, 10, 12, 14]], np.int32)
    starts, valid = pa.plan_blocks(table, 4)
    assert (valid[0] > 0).sum() == 8        # one descriptor per page
    assert (valid[0][valid[0] > 0] == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_vs_plain_on_gpu(cuda, dtype):
    B, H, Kh, D, T, P, Pmax = 3, 8, 4, 32, 8, 40, 6
    rng = np.random.default_rng(7)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for R in (1, 2, 4):
        for contig in (True, False):
            q = torch.from_numpy(rng.normal(size=(B, H, D))).to(cuda, dtype)
            kv = torch.from_numpy(rng.normal(size=(P, T, 2, Kh, D))).to(cuda, dtype)
            table = random_table(rng, B, Pmax, P, contig)
            lengths = torch.from_numpy(
                ((table >= 0).sum(1) * T - rng.integers(0, T, B)).astype(np.int32))
            before = pa.launches
            out = pa.paged_attention(q, kv, table, lengths.to(cuda), pages_per_block=R)
            torch.cuda.synchronize()
            assert pa.launches == before + 1
            plan = pa.upload_plan(table, R, torch.device("cpu"))
            plain = pa.paged_attention_plain(q.cpu(), kv.cpu(), *plan, lengths,
                                             pages_per_block=R)
            close(out, plain, tol)


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
