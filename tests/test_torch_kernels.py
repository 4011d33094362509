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
from repro_torch.kernels.ring_attention import ops as ra  # noqa: E402
from repro_torch.kernels.ring_attention.ref import ring_attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref as ssd_oracle  # noqa: E402

DTYPES = ["float32", "bfloat16"]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # test_flash_vs_ref
PAGED_TOL = {"float32": 1e-5, "bfloat16": 3e-2}    # test_paged_attention_vs_ref

SSD_TOL = 1e-4                                    # test_ssd_vs_ref
SSD_SHAPES = [     # B, L, H, P, N, chunk (tests/test_kernels.py::test_ssd_vs_ref)
    (2, 128, 3, 16, 8, 32),
    (1, 64, 2, 32, 16, 64),
    (2, 96, 4, 8, 4, 16),
    (1, 256, 1, 64, 32, 64),
]

FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window, Pallas q_block, kv_block
    (128, 128, 4, 2, 32, True, None, 64, 64),
    (128, 128, 4, 4, 64, False, None, 32, 64),
    (256, 256, 8, 2, 32, True, 96, 64, 32),
    (64, 192, 2, 2, 32, True, None, 32, 32),
    (64, 64, 2, 1, 128, True, None, 64, 64),
    (64, 64, 2, 2, 192, True, None, 64, 64),    # MLA's qk_nope + qk_rope (deepseek)
]


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (needs JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention_op
    from repro.kernels.flash_attention.ref import attention_ref as flash_oracle
    from repro.kernels.paged_attention import ops as paged_ops
    from repro.kernels.paged_attention.ref import paged_attention_ref as paged_oracle
    from repro.kernels.ssd_scan.ops import ssd_scan_op
    from repro.kernels.ssd_scan.ref import ssd_ref
    return SimpleNamespace(jnp=jnp, flash=flash_attention_op, flash_oracle=flash_oracle,
                           paged=paged_ops, paged_oracle=paged_oracle, ssd=ssd_scan_op,
                           ssd_oracle=ssd_ref)


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


FLASH_GPU_SHAPES = [   # B, Sq, Skv, H, Kh, D, causal, window
    *[(2, *s[:7]) for s in FLASH_SHAPES],
    (4, 64, 64, 16, 16, 64, True, None),        # qwen1.5-0.5b prefill (serving)
    (1, 4096, 4096, 16, 16, 64, True, None),    # long prompt: many KV tiles a q tile
    # enough q tiles for 128-row tiles, with ragged Sq and Skv, GQA, a window
    (4, 1000, 1500, 8, 2, 64, True, 300),
    (4, 1000, 1500, 8, 2, 32, False, None),
    (4, 64, 64, 16, 16, 192, True, None),       # deepseek prefill (MLA, D 192)
    (2, 300, 300, 4, 4, 192, True, None),       # D 192, ragged tiles
    (4, 1280, 1280, 25, 5, 64, True, 1024),     # hymba prefill: G 5, window 1024
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_vs_plain_on_gpu(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for B, Sq, Skv, H, Kh, D, causal, window in FLASH_GPU_SHAPES:
        q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
        k = torch.randn(B, Skv, Kh, D, generator=g, device=cuda).to(dtype)
        v = torch.randn(B, Skv, Kh, D, generator=g, device=cuda).to(dtype)
        before = fa.launches
        out = fa.flash_attention_op(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        close(out, attention_ref(q, k, v, causal=causal, window=window), tol)


def flash_bf16_p(q, k, v, *, causal, window, block=64):
    """The bf16 kernel's numerics in plain torch: 64 × 64 tiles, scores scaled
    by D^-0.5·log2(e) and exponentiated with exp2, the row sums in f32, and P
    rounded to bf16 before P·V, as the tensor-core kernel feeds it to the mma."""
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    qh = q.float().reshape(B, Sq, Kh, H // Kh, D)
    kf, vf = k.float(), v.float()
    scale = D ** -0.5 * 1.4426950408889634
    q_pos = torch.arange(Sq) + Skv - Sq
    m = torch.full((B, Kh, H // Kh, Sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kh, H // Kh, Sq, D))
    for k0 in range(0, Skv, block):
        kv_pos = torch.arange(k0, min(k0 + block, Skv))
        s = torch.einsum("bqkgd,btkd->bkgqt", qh, kf[:, k0:k0 + block]) * scale
        mask = torch.ones((Sq, len(kv_pos)), dtype=torch.bool)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(torch.bfloat16).float(), vf[:, k0:k0 + block])
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


@pytest.mark.parametrize("Sq,Skv,H,Kh,D,causal,window,qb,kb", FLASH_SHAPES)
def test_flash_bf16_p_numerics_hold_the_oracle(ref, Sq, Skv, H, Kh, D, causal, window,
                                               qb, kb):
    """Rounding P to bf16 before P·V (the tensor-core kernel's design) keeps
    the bf16 tolerance on every reference shape."""
    rng = np.random.default_rng(Sq + Skv + H + D)
    qj, qt = both(ref, rng, (2, Sq, H, D), "bfloat16")
    kj, kt = both(ref, rng, (2, Skv, Kh, D), "bfloat16")
    vj, vt = both(ref, rng, (2, Skv, Kh, D), "bfloat16")
    oracle = ref.flash_oracle(qj, kj, vj, causal=causal, window=window)
    close(flash_bf16_p(qt, kt, vt, causal=causal, window=window), oracle,
          FLASH_TOL["bfloat16"])


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


def gqa_group_inputs(rng, G):
    """D 128 decode at GQA group G (qwen2.5-32b's 5, llava-next-34b's 7): 2 KV
    heads, pages of 16, lengths that end on a page, mid-page, and at one
    token. Returns numpy (q, pool, table, lengths)."""
    B, Kh, D, T, Pmax = 3, 2, 128, 16, 9
    P = B * Pmax + 4
    q = rng.normal(size=(B, G * Kh, D))
    kv = rng.normal(size=(P, T, 2, Kh, D))
    table = rng.permutation(P)[:B * Pmax].reshape(B, Pmax).astype(np.int32)
    lengths = np.array([Pmax * T, 87, 1], np.int32)
    return q, kv, table, lengths


@pytest.mark.parametrize("G", [5, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_vs_reference_at_gqa_groups(ref, G, dtype):
    """The plain paged attention (what the CPU runs) against the JAX oracle at
    the groups that go through the kernel's padded G 8 instance on the card."""
    rng = np.random.default_rng(40 + G)
    q, kv, table, lengths = gqa_group_inputs(rng, G)
    qj = ref.jnp.asarray(q, getattr(ref.jnp, dtype))
    kvj = ref.jnp.asarray(kv, getattr(ref.jnp, dtype))
    qt, kvt = (torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
               for x in (qj, kvj))
    oracle = ref.paged_oracle(qj, kvj, ref.jnp.asarray(table), ref.jnp.asarray(lengths))
    for R in (1, 4):
        out = pa.paged_attention(qt, kvt, table, torch.from_numpy(lengths),
                                 pages_per_block=R)
        assert out.dtype == getattr(torch, dtype) and out.shape == qt.shape
        close(out, oracle, PAGED_TOL[dtype])


@pytest.mark.parametrize("G", [5, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_gqa_groups_on_gpu(cuda, G, dtype):
    """The same inputs through the CUDA kernel against the plain version."""
    q, kv, table, lengths = gqa_group_inputs(np.random.default_rng(40 + G), G)
    qt, kvt = (torch.from_numpy(x.astype(np.float32)).to(cuda, dtype) for x in (q, kv))
    lt = torch.from_numpy(lengths).to(cuda)
    tol = PAGED_TOL[str(dtype).split(".")[1]]
    for R in (1, 4):
        before = pa.launches
        out = pa.paged_attention(qt, kvt, table, lt, pages_per_block=R)
        torch.cuda.synchronize()
        assert pa.launches == before + 1
        plan = pa.upload_plan(table, R, cuda)
        close(out, pa.paged_attention_plain(qt, kvt, *plan, lt, pages_per_block=R), tol)


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
# paged attention: the CUDA kernel's split schedule, emulated on the CPU
# ---------------------------------------------------------------------------

def paged_split_schedule(q, kv, block_start, block_valid, lengths, *, pages_per_block,
                         splits, live_blocks, heads=1):
    """The kernel's schedule in plain torch, f32 in the log2 domain: split s of
    sequence b walks descriptors [s·per, (s+1)·per) (per = ceil(live/S), the
    last split on to NB) from cnt = Σ_{j<first} valid[b, j], one stage of at
    most C tokens at a time (C from the row of ``heads`` KV heads a CTA
    copies), stopping at the length; each split leaves a partial (acc, m, l)
    per head; the combine merges them. Returns (out, partials) with partials
    (B, Kh, S, G, D + 2)."""
    B, H, D = q.shape
    P, T, _, Kh, _ = kv.shape
    G, NB, S = H // Kh, block_start.shape[1], splits
    C = pa.box_tokens(pages_per_block * T, 2 * heads * D * kv.element_size())
    per = -(-live_blocks // S)
    scale = D ** -0.5 * 1.4426950408889634
    rows = kv.reshape(P * T, 2, Kh, D).float()
    starts, valid = block_start.long(), block_valid.long()
    partials = torch.zeros(B, Kh, S, G, D + 2)
    for b in range(B):
        length, qh = int(lengths[b]), q[b].reshape(Kh, G, D).float()
        for s in range(S):
            first = min(NB, s * per)
            last = NB if s == S - 1 else min(NB, first + per)
            cnt = int(valid[b, :first].sum())
            m, l, acc = torch.full((Kh, G), -1e30), torch.zeros(Kh, G), torch.zeros(Kh, G, D)
            for i in range(first, last):
                if cnt * T >= length:
                    break                                   # past the length
                nvalid = int(valid[b, i])
                ntok = min(nvalid * T, length - cnt * T)
                for c0 in range(0, max(ntok, 0), C):
                    tok = int(starts[b, i]) * T + c0 + torch.arange(min(C, ntok - c0))
                    k, v = rows[tok, 0], rows[tok, 1]       # (n, Kh, D)
                    sc = torch.einsum("kgd,nkd->kgn", qh, k) * scale
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp2(sc - m_new[..., None])
                    corr = torch.exp2(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum("kgn,nkd->kgd", p, v)
                    m = m_new
                cnt += nvalid
            partials[b, :, s] = torch.cat([acc, m[..., None], l[..., None]], -1)
    m_all = partials[..., D].amax(dim=2, keepdim=True)                # (B, Kh, 1, G)
    c = torch.exp2(partials[..., D] - m_all)
    l_all = (partials[..., D + 1] * c).sum(2)
    acc_all = (partials[..., :D] * c[..., None]).sum(2)
    out = acc_all / l_all.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype), partials


GD = [(G, D) for G in (1, 2, 8) for D in (32, 64, 128)]
SPLIT_CASES = [(R, contig, dtype, *GD[i % len(GD)]) for i, (R, contig, dtype) in enumerate(
    (R, c, d) for R in (1, 2, 4) for c in (True, False) for d in DTYPES)]


@pytest.mark.parametrize("R,contig,dtype,G,D", SPLIT_CASES)
def test_paged_split_schedule_vs_reference(ref, R, contig, dtype, G, D):
    """Every split count from 1 to the live-descriptor count gives the JAX
    oracle's and the interpret-mode Pallas kernel's answer; each split starts
    from its own cnt, and the combine merges the partials."""
    B, Kh, T, P, Pmax = 3, 2, 8, 48, 8
    H = G * Kh
    rng = np.random.default_rng(100 * R + 10 * contig + G + D)
    qj, qt = both(ref, rng, (B, H, D), dtype)
    kvj, kvt = both(ref, rng, (P, T, 2, Kh, D), dtype)
    table = random_table(rng, B, Pmax, P, contig)
    table[0, :] = -1                       # one sequence spans every column: most live
    table[0] = (np.arange(Pmax) if contig else rng.choice(P, Pmax, replace=False))
    lengths = ((table >= 0).sum(1) * T - rng.integers(0, T, B)).astype(np.int32)
    jnp, tol = ref.jnp, PAGED_TOL[dtype]
    oracle = ref.paged_oracle(qj, kvj, jnp.asarray(table), jnp.asarray(lengths))
    pallas = ref.paged.paged_attention(qj, kvj, table, jnp.asarray(lengths),
                                       pages_per_block=R)
    close(pallas, oracle, tol)
    starts, valid = pa.plan_blocks(table, R)
    live = pa.count_live_blocks(valid, lengths, T)
    assert live >= (valid[0] > 0).sum() >= 2   # sequence 0's descriptors are all live
    empty_splits = 0
    for S in range(1, live + 1):
        for heads in (1, 2):                   # one or both KV heads a CTA: other stages
            out, partials = paged_split_schedule(
                qt, kvt, torch.from_numpy(starts), torch.from_numpy(valid),
                torch.from_numpy(lengths), pages_per_block=R, splits=S, live_blocks=live,
                heads=heads)
            assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, D)
            close(out, oracle, tol)
            close(out, pallas, tol)
            empty_splits += int((partials[..., D + 1] == 0).all(-1).sum())
    if live > 1:
        assert empty_splits > 0            # shorter sequences leave splits with no live token


def test_paged_split_with_no_live_token(ref):
    """A short sequence beside a long one: at S = live its later splits see
    valid pages past its length, stay (m, l, acc) = (−1e30, 0, 0), and the
    combine still gives the oracle's answer; so does the last split, which
    runs on over trailing empty descriptors."""
    B, H, Kh, D, T, R, P = 2, 4, 2, 32, 8, 1, 24
    rng = np.random.default_rng(3)
    qj, qt = both(ref, rng, (B, H, D), "float32")
    kvj, kvt = both(ref, rng, (P, T, 2, Kh, D), "float32")
    table = -np.ones((B, 10), np.int32)
    table[:, :8] = np.arange(16).reshape(B, 8)
    lengths = np.array([8 * T, 5], np.int32)
    starts, valid = pa.plan_blocks(table, R)
    live = pa.count_live_blocks(valid, lengths, T)
    assert live == 8 and (valid[1] > 0).sum() == 8     # 8 valid, 1 live for sequence 1
    out, partials = paged_split_schedule(
        qt, kvt, torch.from_numpy(starts), torch.from_numpy(valid), torch.from_numpy(lengths),
        pages_per_block=R, splits=live, live_blocks=live)
    assert (partials[1, :, 1:, :, D + 1] == 0).all()
    assert (partials[1, :, 1:, :, D] == -1e30).all()
    assert (partials[0, :, :, :, D + 1] > 0).all()
    jnp = ref.jnp
    close(out, ref.paged_oracle(qj, kvj, jnp.asarray(table), jnp.asarray(lengths)),
          PAGED_TOL["float32"])


def test_paged_split_count():
    """S = 1 at qwen1.5-0.5b's serving shape (B·Kh = 64, 96 tokens = 2 live
    descriptors at R = 4); S > 1 at 8192 tokens (128 live); never more
    splits than live descriptors, and enough CTAs for two an SM when there
    are descriptors to share."""
    sms = 132
    assert pa.split_count(4 * 16, 2, sms) == 1
    long_ctx = pa.split_count(4 * 16, 128, sms)
    assert long_ctx > 1 and 4 * 16 * long_ctx >= 2 * sms
    assert sms <= pa.split_count(1, 4096, sms) <= 2 * sms   # 16 descriptors a split
    for bkh in (1, 8, 64, 512):
        for live in range(0, 300, 7):
            S = pa.split_count(bkh, live, sms)
            assert 1 <= S <= max(1, live)
            assert S == 1 or live // S >= pa.MIN_BLOCKS_PER_SPLIT
            per = -(-live // S)
            assert live == 0 or (S - 1) * per < live      # the kernel's last split has work


def test_paged_launch_shape():
    """qwen1.5-0.5b's heads (bf16, D 64, pages of 16): at R = 4 a run is one
    16 KB stage, so one KV head a CTA, S = 1 at the serving shape and 5
    splits of ≤ 26 runs at 8192 tokens; at R = 1 a run is 4 KB, so 4 heads
    a CTA share a stage, in 17 splits with no empty one; a head count that
    4 does not divide takes 2; a run of a stage or more never widens."""
    sms, run4, run1 = 132, 4 * 16 * 256, 16 * 256
    assert pa.launch_shape(4, 16, 2, sms, run4) == (1, 1)
    assert pa.launch_shape(4, 16, 128, sms, run4) == (1, 5)
    assert pa.launch_shape(4, 16, 512, sms, run1) == (4, 17)
    assert pa.launch_shape(4, 6, 512, sms, run1)[0] == 2
    assert pa.launch_shape(1, 1, 512, sms, run1) == (1, pa.split_count(1, 512, sms))
    for B, Kh, live in ((4, 16, 128), (2, 8, 64), (1, 2, 300), (8, 4, 9)):
        for run in (run1, run4, 2 * run4):
            heads, S = pa.launch_shape(B, Kh, live, sms, run)
            assert Kh % heads == 0 and 1 <= S <= max(1, live)
            assert heads == 1 or heads * run <= pa.STAGE_BYTES


def test_paged_box_tokens():
    """A stage is a whole run when it fits 16 KB (R 4, pages of 16, bf16 D 64
    K and V rows of 256 bytes), else the fewest equal pieces; never above
    TMA's 256-token box."""
    assert pa.box_tokens(64, 256) == 64
    assert pa.box_tokens(64, 1024) == 16
    assert pa.box_tokens(64, 2048) == 8
    assert pa.box_tokens(16, 1024) == 16
    assert pa.box_tokens(512, 32) == 256
    assert pa.box_tokens(8, 64 * 1024) == 1


def test_count_live_blocks_stops_at_the_length():
    table = np.arange(12, dtype=np.int32).reshape(2, 6)
    starts, valid = pa.plan_blocks(table, 2)
    assert (valid > 0).sum(1).tolist() == [3, 3]
    assert pa.count_live_blocks(valid, np.array([96, 96]), 16) == 3
    assert pa.count_live_blocks(valid, np.array([33, 1]), 16) == 2
    assert pa.count_live_blocks(valid, np.array([32, 1]), 16) == 1


def test_decode_plan_counts_live_blocks():
    """PagedKVPool gives a sequence all its pages up front; early in decode
    the plan counts only the descriptors below the length."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.attention import PagedKVPool
    cfg = get_reduced("qwen1.5-0.5b")
    pool = PagedKVPool(cfg, 2, 256, page_tokens=16, pages_per_block=4,
                       device=torch.device("cpu"))
    assert pool.plan_step(np.array([10, 64])).live_blocks == 2
    assert pool.plan_step(np.array([10, 20])).live_blocks == 1
    assert pool.plan_step(np.array([255, 0])).live_blocks == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_edge_cases_on_gpu(cuda, dtype):
    """Every G and D, lengths ending mid-page, mid-stage and on a split
    boundary, trailing empty descriptors, a fragmented R = 1 table, a pool
    view at layer 2 of 3, forced splits with empty ones and 4096 tokens at
    S > 1, against the plain version and the oracle (chip_smoke.py's cases)."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    saw_split = False
    for case in chip_smoke.paged_edge_cases(cuda, gen, dtype):
        before = pa.launches
        row = chip_smoke.check_paged_case(case, PAGED_TOL[str(dtype).split(".")[1]])
        assert pa.launches == before + 1
        saw_split |= row["case"].startswith("4096") and row["splits"] > 1
    assert saw_split


def test_paged_wrapper_rejects_misaligned_pool_on_gpu(cuda):
    q = torch.zeros(1, 2, 32, device=cuda)
    flat = torch.zeros(4 * 8 * 2 * 2 * 32 + 1, device=cuda)
    kv = flat[1:].view(4, 8, 2, 2, 32)                 # 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention(q, kv, np.array([[0, 1]], np.int32),
                           torch.tensor([16], dtype=torch.int32, device=cuda),
                           pages_per_block=2)


# ---------------------------------------------------------------------------
# ring decode attention (sliding-window archs)
# ---------------------------------------------------------------------------

RING_SLOTS = 48
RING_STEPS = {     # each sequence's position: a ring filling, full, wrapped past its end
    "filling": [0, 7, RING_SLOTS - 2],
    "full": [RING_SLOTS - 1] * 3,
    "wrapped": [RING_SLOTS + 5, 2 * RING_SLOTS + 17, 3 * RING_SLOTS - 2],
}


def ring_step(G, D, cur, dtype=torch.bfloat16, Kh=2, seed=0):
    """q, a ring of random K/V, and the ring cache's own plan for positions
    ``cur``: (q, k, v, valid, cur as a tensor)."""
    from repro_torch.models.attention import SlotCache
    rng = np.random.default_rng(seed)
    B = len(cur)
    cache = SlotCache(1, B, RING_SLOTS, [(Kh, D)] * 2, device=torch.device("cpu"))
    valid = cache.plan_step(np.array(cur)).valid.clone()

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    return (draw(B, Kh * G, D), draw(B, RING_SLOTS, Kh, D), draw(B, RING_SLOTS, Kh, D),
            valid, torch.tensor(cur))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("steps", list(RING_STEPS))
def test_ring_plain_vs_reference(steps, G, D):
    """The plain version on the ring cache's plan against the reference's
    windowed ``attention_decode`` arithmetic on the positions alone."""
    q, k, v, valid, cur = ring_step(G, D, RING_STEPS[steps])
    assert int(valid.sum()) == sum(min(c + 1, RING_SLOTS) for c in RING_STEPS[steps])
    out = ra.ring_attention(q, k, v, valid, D ** -0.5)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ring_attention_ref(q, k, v, cur).float(),
                               rtol=0, atol=0)
    # the same function in f32, and the wrapper on the CPU is the plain version
    q32, k32, v32 = q.float(), k.float(), v.float()
    torch.testing.assert_close(ra.ring_attention_plain(q32, k32, v32, valid, D ** -0.5),
                               ring_attention_ref(q32, k32, v32, cur), rtol=1e-6, atol=1e-6)


def test_ring_meta_op_counts_every_slot():
    """On meta tensors: the output's shape and dtype, the kernel's flops
    (q·K and P·V over every slot) and bytes (q, out, the ring, the mask)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import BYTES
    B, H, Kh, D, S = 64, 25, 5, 64, 1024
    meta = torch.device("meta")
    q = torch.empty(B, H, D, dtype=torch.bfloat16, device=meta)
    k = torch.empty(B, S, Kh, D, dtype=torch.bfloat16, device=meta)
    valid = torch.empty(B, S, dtype=torch.bool, device=meta)
    with FlopCounterMode(display=False) as fc:
        out = ra.ring_attention(q, k, k, valid, D ** -0.5)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
    assert fc.get_total_flops() == 4 * D * H * S * B == 419_430_400
    nbytes = BYTES[torch.ops.repro_torch.ring_attention](q, k, k, valid, D ** -0.5, result=out)
    assert nbytes == 2 * B * H * D * 2 + 2 * B * S * Kh * D * 2 + B * S
    assert 2 * B * S * Kh * D * 2 == 83_886_080          # the ring: 83.9 MB a layer
    with pytest.raises(NotImplementedError, match="meta tensors only"):
        torch.ops.repro_torch.ring_attention(torch.zeros(1, 2, 32), torch.zeros(1, 4, 1, 32),
                                             torch.zeros(1, 4, 1, 32),
                                             torch.ones(1, 4, dtype=torch.bool), 0.125)


def test_ring_split_count():
    """Splits fill 2 CTAs an SM over (sequence, KV head) pairs, at least 256
    slots each, and never leave a trailing split without a slot."""
    assert ra.split_count(64 * 5, 1024, 132) == 1          # hymba-1.5b's decode
    assert ra.split_count(16 * 5, 1024, 132) == 4
    assert ra.split_count(4 * 5, 1024, 132) == 4           # capped by 256 slots a split
    assert ra.split_count(4, 64, 132) == 1                 # too short to split
    assert ra.split_count(4, 1024, 132) == 4
    assert ra.split_count(1024, 1024, 132) == 1            # the grid fills the card
    assert ra.split_count(1000, 100_000, 8) == 4           # 32,768 slots a split at most
    for ctas, length in ((3, 1000), (7, 513), (2, 300)):
        S = ra.split_count(ctas, length, 132)
        per = -(-length // S)
        assert (S - 1) * per < length


def test_ring_takes_the_plain_path_where_the_kernel_has_no_instance():
    """``kernel_takes`` names the instances (bf16 or f32, q and ring of one
    dtype, (D, G) in INSTANCES): on the card any other input raises. On the
    CPU every input, instanced or not, runs the plain version."""
    bf16 = torch.bfloat16
    for D, G in ra.INSTANCES:
        for dtype in (bf16, torch.float32):
            assert ra.kernel_takes(torch.zeros(2, 2 * G, D, dtype=dtype),
                                   torch.zeros(2, 8, 2, D, dtype=dtype))
    assert not ra.kernel_takes(torch.zeros(2, 4, 32),                    # f32 q, bf16 ring
                               torch.zeros(2, 8, 2, 32, dtype=bf16))
    assert not ra.kernel_takes(torch.zeros(2, 4, 32, dtype=torch.float16),  # f16
                               torch.zeros(2, 8, 2, 32, dtype=torch.float16))
    assert not ra.kernel_takes(torch.zeros(2, 4, 48, dtype=bf16),         # D 48
                               torch.zeros(2, 8, 2, 48, dtype=bf16))
    assert not ra.kernel_takes(torch.zeros(2, 18, 32, dtype=bf16),        # G 9
                               torch.zeros(2, 8, 2, 32, dtype=bf16))
    assert not ra.kernel_takes(torch.zeros(2, 6, 64, dtype=bf16),         # G 3 at D 64
                               torch.zeros(2, 8, 2, 64, dtype=bf16))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, 48, generator=gen).to(bf16)
    k, v = (torch.randn(2, 8, 2, 48, generator=gen).to(bf16) for _ in range(2))
    valid = torch.ones(2, 8, dtype=torch.bool)
    torch.testing.assert_close(ra.ring_attention(q, k, v, valid, 48 ** -0.5),
                               ra.ring_attention_plain(q, k, v, valid, 48 ** -0.5),
                               rtol=0, atol=0)


def test_ring_kernel_vs_plain_at_hymba_decode_on_gpu(cuda):
    """B 64, H 25, Kh 5, D 64, 1024 slots: a full ring and one filling, to
    one bf16 ulp of the plain version's output; the kernel serves the call."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    for cur in (np.full(64, 2047 + 1024), np.arange(64) * 16):
        q, k, v, valid = chip_smoke.ring_inputs(cuda, gen, 64, 25, 5, 64, 1024, cur)
        before = ra.launches
        out = ra.ring_attention(q, k, v, valid, 64 ** -0.5)
        torch.cuda.synchronize()
        assert ra.launches == before + 1
        assert chip_smoke.bf16_ulps(out, ra.ring_attention_plain(q, k, v, valid, 64 ** -0.5)) <= 1


def test_ring_kernel_edge_cases_on_gpu(cuda):
    """One valid slot, B 1, forced splits holding no valid slot, valid slots
    across the ring's end, every instance's (D, G), a ring view at layer 1 of
    2 (chip_smoke.py's cases), in bf16 to one bf16 ulp and in f32 to
    chip_smoke.RING_F32_TOL; the same bits twice."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    dtypes = set()
    for case in chip_smoke.ring_edge_cases(cuda, gen):
        before = ra.launches
        row = chip_smoke.check_ring_case(case)
        dtypes.add(row["q"])
        assert ra.launches == before + 2
        assert row["ulps"] <= 1 if "ulps" in row else row["max_abs_err"] <= 1e-5
    assert dtypes == {"torch.bfloat16", "torch.float32"}


def test_ring_f32_launches_the_kernel_and_other_inputs_raise_on_gpu(cuda):
    """An f32 model's ring runs the kernel's f32 instance at hymba's heads and
    its reduced copy's, within chip_smoke.RING_F32_TOL of the plain version;
    mixed dtypes, f16, and a (D, G) with no instance raise and launch
    nothing."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    for B, H, Kh, D, cur in ((64, 25, 5, 64, np.full(64, 2047)), (3, 4, 2, 32, [5, 70, 200])):
        q, k, v, valid = chip_smoke.ring_inputs(cuda, gen, B, H, Kh, D, 64 if D == 32 else 1024,
                                                cur, dtype=torch.float32)
        before = ra.launches
        out = ra.ring_attention(q, k, v, valid, D ** -0.5)
        torch.cuda.synchronize()
        assert ra.launches == before + 1 and out.dtype == torch.float32
        torch.testing.assert_close(out, ra.ring_attention_plain(q, k, v, valid, D ** -0.5),
                                   rtol=chip_smoke.RING_F32_TOL, atol=chip_smoke.RING_F32_TOL)
    valid = torch.ones(2, 16, dtype=torch.bool, device=cuda)
    bad = ((torch.float32, torch.bfloat16, 32, 4, TypeError),
           (torch.bfloat16, torch.float32, 32, 4, TypeError),
           (torch.float16, torch.float16, 32, 4, TypeError),
           (torch.bfloat16, torch.bfloat16, 48, 4, ValueError),
           (torch.bfloat16, torch.bfloat16, 64, 6, ValueError))
    for q_dtype, ring_dtype, D, H, err in bad:
        q = torch.randn(2, H, D, device=cuda).to(q_dtype)
        k = torch.randn(2, 16, 2, D, device=cuda).to(ring_dtype)
        before = ra.launches
        with pytest.raises(err, match="ring_attention"):
            ra.ring_attention(q, k, k, valid, D ** -0.5)
        assert ra.launches == before


# ---------------------------------------------------------------------------
# SSD chunk scan
# ---------------------------------------------------------------------------

def ssd_inputs(rng, B, L, H, P, N, A=None):
    """test_ssd_vs_ref's distributions as float32 numpy arrays."""
    x = (rng.normal(size=(B, L, H, P)) * 0.5).astype(np.float32)
    Bm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(B, L, H)).astype(np.float32)
    if A is None:
        A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    return x, Bm, Cm, dt, A


@pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_vs_reference(ref, B, L, H, P, N, chunk):
    """The port's wrapper (CPU: ssd_chunked) and its oracle against the JAX
    Pallas kernel (interpret mode) and the JAX oracle, on the same inputs."""
    arrays = ssd_inputs(np.random.default_rng(B + L + H + P + N + chunk), B, L, H, P, N)
    jx = [ref.jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    pallas = ref.ssd(*jx, chunk=chunk)
    oracle = ref.ssd_oracle(*jx)
    out = ssd.ssd_scan_op(*tx, chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (B, L, H, P)
    close(out, pallas, SSD_TOL)
    close(out, oracle, SSD_TOL)
    close(ssd_oracle(*tx), oracle, SSD_TOL)
    y, h = ssd_chunked(*tx, chunk=chunk)
    close(y, oracle, SSD_TOL)
    assert h.shape == (B, H, N, P) and h.dtype == torch.float32


def test_ssd_state_continuity_across_chunks(ref):
    """Splitting L into more chunks must not change the result (twin of
    tests/test_kernels.py::test_ssd_state_continuity_across_chunks), nor the
    final state."""
    B, L, H, P, N = 1, 128, 2, 8, 4
    arrays = ssd_inputs(np.random.default_rng(11), B, L, H, P, N,
                        A=-np.ones((H,), np.float32))
    tx = [torch.from_numpy(a) for a in arrays]
    a, ha = ssd.ssd_scan_op(*tx, chunk=16, return_state=True)
    b, hb = ssd.ssd_scan_op(*tx, chunk=128, return_state=True)
    close(a, b, SSD_TOL)
    close(ha, hb, SSD_TOL)
    close(a, ref.ssd(*[ref.jnp.asarray(x) for x in arrays], chunk=16), SSD_TOL)


def test_ssd_final_state_matches_ssm_train(ref):
    """h_final against the reference's ssm_train(..., return_state=True)["h"]:
    the scan inputs are formed from the reference's own projections and conv
    (ssm.py:73-84) and fed to the port's scan."""
    import jax
    from repro.configs import get_reduced
    from repro.models.layers import SpecTree
    from repro.models.ssm import _conv_scan, init_ssm, ssm_train
    jnp = ref.jnp
    cfg = get_reduced("mamba2-780m")
    p = init_ssm(jax.random.PRNGKey(0), cfg, SpecTree())
    p["A_log"] = jnp.asarray(np.random.default_rng(1).normal(size=cfg.ssm_heads),
                             jnp.bfloat16)
    B, L = 2, 2 * cfg.ssm_chunk
    H, P, N, Din = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_heads * cfg.ssm_head_dim
    x = jnp.asarray(np.random.default_rng(2).normal(size=(B, L, cfg.d_model)),
                    jnp.bfloat16)
    _, state = ssm_train(p, x, cfg, None, return_state=True)
    xBC = _conv_scan(jnp.einsum("blm,mc->blc", x, p["w_xbc"]), p["conv_w"],
                     p["conv_b"], L)
    dt = jax.nn.softplus(jnp.einsum("blm,mh->blh", x, p["w_dt"]).astype(jnp.float32)
                         + p["dt_bias"].astype(jnp.float32))
    A = -jnp.exp(p["A_log"].astype(jnp.float32))
    parts = (xBC[..., :Din].reshape(B, L, H, P), xBC[..., Din:Din + N],
             xBC[..., Din + N:], dt, A)
    tx = [torch.from_numpy(np.array(a, np.float32)) for a in parts]
    _, h = ssd.ssd_scan_op(*tx, chunk=cfg.ssm_chunk, return_state=True)
    close(h, state["h"], SSD_TOL)


def tf32(a):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero on the int32 view, as cvt.rna.tf32.f32 rounds."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(eq, a, b, terms):
    """einsum(eq, a, b) on TF32 operands. terms=3 is the kernel's 3×TF32: each
    f32 operand split as hi = tf32(x), lo = tf32(x − hi); lo·hi + hi·lo +
    hi·hi in f32. terms=1 is one TF32 product, hi·hi."""
    a_hi, b_hi = tf32(a), tf32(b)
    if terms == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def ssd_chunked_tf32(x, Bm, Cm, dt, A, *, chunk, terms=3):
    """ssd_chunked with every product on TF32 operands (``mm_tf32``), formed
    as the kernel forms its operands: C·Bᵀ once per (b, chunk), the masked
    scores, C·h_prev, and the state update's A operand (B ⊙ w)ᵀ."""

    def mm(eq, a, b):
        return mm_tf32(eq, a, b, terms)

    Bb, L, H, P = x.shape
    N, K = Bm.shape[-1], chunk
    causal = torch.ones((K, K), dtype=torch.bool).tril()
    h = torch.zeros((Bb, H, N, P))
    ys = []
    for c0 in range(0, L, K):
        xk, Bk, Ck, dtk = (t[:, c0:c0 + K] for t in (x, Bm, Cm, dt))
        cs = torch.cumsum(dtk * A, dim=1)                                 # (B, K, H)
        diff = (cs[:, :, None, :] - cs[:, None, :, :]).clamp(max=0.0)
        Lmat = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        scores = mm("bin,bjn->bij", Ck, Bk)[..., None] * Lmat * dtk[:, None, :, :]
        y = mm("bijh,bjhp->bihp", scores, xk)
        y = y + mm("bkn,bhnp->bkhp", Ck, h) * torch.exp(cs)[..., None]
        w = dtk * torch.exp(cs[:, -1:, :] - cs)                           # (B, K, H)
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] + mm(
            "bkhn,bkhp->bhnp", Bk[:, :, None, :] * w[..., None], xk)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    r = tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((r - x).abs() > 0).any()
    assert tf32(torch.tensor([1 + 2.0 ** -11])).item() == 1 + 2.0 ** -10   # tie: away


@pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_SHAPES + [(1, 128, 2, 8, 4, 16)])
def test_ssd_3xtf32_numerics_hold_the_oracle(B, L, H, P, N, chunk):
    """The tensor-core kernel's 3×TF32 products keep the 1e-4 tolerance on the
    four reference shapes and the continuity case (A = −1, chunk 16)."""
    A = -np.ones((H,), np.float32) if chunk == 16 and L == 128 else None
    arrays = ssd_inputs(np.random.default_rng(B + L + H + P + N + chunk), B, L, H, P, N, A=A)
    tx = [torch.from_numpy(a) for a in arrays]
    y, h = ssd_chunked_tf32(*tx, chunk=chunk)
    close(y, ssd_oracle(*tx), SSD_TOL)
    close(h, ssd_chunked(*tx, chunk=chunk)[1], SSD_TOL)


def test_one_tf32_product_misses_the_ssd_tolerance():
    """Why the kernel splits: one TF32 product (~1e-3 relative) drifts past
    the 1e-4 tolerance on the reference shape with the longest chunks."""
    B, L, H, P, N, chunk = SSD_SHAPES[3]
    arrays = ssd_inputs(np.random.default_rng(B + L + H + P + N + chunk), B, L, H, P, N)
    tx = [torch.from_numpy(a) for a in arrays]
    y, _ = ssd_chunked_tf32(*tx, chunk=chunk, terms=1)
    assert (y - ssd_oracle(*tx)).abs().max().item() > SSD_TOL


def test_ssd_rejects_a_length_off_the_chunk():
    x = torch.zeros(1, 48, 1, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan_op(x, torch.zeros(1, 48, 4), torch.zeros(1, 48, 4),
                        torch.zeros(1, 48, 1), torch.zeros(1), chunk=32)


SSD_GPU_SHAPES = SSD_SHAPES + [   # + the mma tiles' padding and ragged edges
    (1, 96, 2, 24, 12, 48),       # K 48, P 24, N 12: part-filled n, k and state tiles
    (2, 64, 3, 8, 4, 16),         # one 16-row m-tile, N 4 and P 8 padded to the tile
    (1, 40, 2, 12, 6, 8),         # K 8 padded to 16 rows
    (1, 21, 2, 5, 3, 7),          # odd K, P and N: the unpaired load and store paths
    (1, 512, 3, 64, 128, 256),    # the serving widths: two P slices, full tiles
]


def test_ssd_kernel_vs_plain_on_gpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain side in true f32
    rng = np.random.default_rng(3)
    for B, L, H, P, N, chunk in SSD_GPU_SHAPES:
        tx = [torch.from_numpy(a).to(cuda) for a in ssd_inputs(rng, B, L, H, P, N)]
        before = ssd.launches
        y, h = ssd.ssd_scan_op(*tx, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        assert ssd.launches == before + 1
        y_plain, h_plain = ssd_chunked(*tx, chunk=chunk)
        # chunk 256: cs runs 256 steps deep, see chip_smoke.py's SSD_SERVING_TOL
        tol = SSD_TOL if chunk < 256 else 1e-3
        close(y, y_plain, tol)
        close(h, h_plain, tol)
        close(y, ssd_oracle(*tx), tol)
        with pytest.raises(TypeError):
            ssd.ssd_scan_op(tx[0].double(), *tx[1:], chunk=chunk)


# ---------------------------------------------------------------------------
# AdamW over every leaf (csrc/adamw.cu)
# ---------------------------------------------------------------------------

# name: (shape, parameter dtype, gradient dtype, storage offset in elements).
# Sizes 1, 3, 4097 and two over 2**20; ndim 1, 2 and 3; bf16 and f32 each way;
# one leaf 2 bytes off 16 (the kernel's element-a-thread path).
ADAMW_LEAVES = {
    "one": ((1,), torch.bfloat16, torch.bfloat16, 0),
    "three": ((3,), torch.float32, torch.float32, 0),
    "odd": ((17, 241), torch.bfloat16, torch.float32, 0),
    "experts": ((3, 7, 49933), torch.float32, torch.bfloat16, 0),
    "matrix": ((1024, 1025), torch.bfloat16, torch.bfloat16, 0),
    "shifted": ((4097,), torch.bfloat16, torch.bfloat16, 1),
}


def adamw_leaves(cuda, seed: int, grad_scale: float):
    """Parameters and one gradient set of ADAMW_LEAVES on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params, grads = {}, {}
    for n, (shape, p_dtype, g_dtype, offset) in ADAMW_LEAVES.items():
        size = int(np.prod(shape))
        buf = torch.empty(size + offset, dtype=p_dtype, device=cuda)
        params[n] = buf[offset:].view(shape)
        params[n].copy_(torch.randn(shape, generator=gen, device=cuda))
        grads[n] = (grad_scale * torch.randn(shape, generator=gen, device=cuda)).to(g_dtype)
    return params, grads


def test_adamw_plan_maps_chunks_to_leaves(monkeypatch):
    """The plan the kernel walks (built on the host, here without a card):
    each leaf's size, first chunk and flags, every chunk owned by the leaf it
    lies in, the grids capped by the chunks; and the address table, a row of
    g, p, m, v, m', v' a leaf."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    monkeypatch.setattr(adamw_ops, "sm_count", lambda device: 2)
    monkeypatch.setattr(adamw_ops, "_upload", lambda a, device: torch.from_numpy(a))
    bf, f32 = torch.bfloat16, torch.float32
    shapes = [(1,), (3,), (0,), (128, 256), (32769,), (2, 3, 7)]
    dtypes = [(bf, bf), (f32, f32), (bf, bf), (f32, bf), (bf, f32), (bf, bf)]
    key = tuple((torch.Size(s), g, p) for s, (g, p) in zip(shapes, dtypes))
    plan = adamw_ops.plan.__wrapped__(torch.device("cpu"), key)    # not cached
    chunks = [-(-int(np.prod(s)) // adamw_ops.CHUNK) for s in shapes]
    assert plan.n_chunks == sum(chunks) == 6
    assert (plan.norm_blocks, plan.update_blocks) == (6, 4)    # capped by chunks, then SMs
    meta = plan.meta.view(-1, 3).tolist()
    owner = plan.chunk_leaf.tolist()
    first = 0
    for i, (shape, (g, p)) in enumerate(zip(shapes, dtypes)):
        n, leaf_first, flags = meta[i]
        assert n == int(np.prod(shape))
        assert leaf_first == first and owner[first:first + chunks[i]] == [i] * chunks[i]
        assert flags == ((adamw_ops.DECAY if len(shape) >= 2 else 0)
                         | (adamw_ops.GRAD_F32 if g == f32 else 0)
                         | (adamw_ops.PARAM_F32 if p == f32 else 0))
        first += chunks[i]
    groups = [[torch.zeros(s) for s in shapes] for _ in range(6)]
    table = adamw_ops.address_table(torch.device("cpu"), *groups).view(-1, 6).tolist()
    assert table == [[group[i].data_ptr() for group in groups] for i in range(len(shapes))]


def dtype_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in steps of their dtype (bf16 or f32), elementwise."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.view(view).long() - b.view(view).long()).abs()


@pytest.mark.parametrize("grad_scale", [1.0, 1e-4])     # clipped, and not
def test_adamw_kernel_vs_plain_on_gpu(cuda, grad_scale):
    """Three steps of ``update`` through the kernel, each held to the plain
    loop from the same state: parameters equal in their dtype on 99.9 % of
    elements and one step apart elsewhere, moments within 2e-6, the norm
    within 1e-6; new moments each step, the old ones unchanged."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.adamw.ref import adamw_plain, clip_by_global_norm_plain
    from repro_torch.optim import adamw
    run = RunConfig(learning_rate=1e-2, total_steps=10, warmup_steps=2, grad_clip=1.0)
    params, _ = adamw_leaves(cuda, 0, grad_scale)
    state = adamw.init(params, run)
    adamw.reset()
    for step in range(1, 4):
        _, grads = adamw_leaves(cuda, step, grad_scale)
        p_plain = {n: p.clone() for n, p in params.items()}
        m_old = {n: t.clone() for n, t in state.m.items()}
        v_old = {n: t.clone() for n, t in state.v.items()}
        ptrs = {n: p.data_ptr() for n, p in params.items()}
        new, metrics = adamw.update(grads, state, params, run)
        clipped, gn_plain = clip_by_global_norm_plain(grads, run.grad_clip)
        m_plain, v_plain = adamw_plain(
            clipped, state.m, state.v, p_plain, lr=adamw.lr_schedule(step, run),
            bc1=1 - 0.9 ** step, bc2=1 - 0.95 ** step, b1=0.9, b2=0.95, eps=1e-8,
            weight_decay=run.weight_decay)
        torch.cuda.synchronize()
        assert adamw.snapshot() == {"fused_steps": step, "plain_steps": 0,
                                    "plain_reason": None, "launches": 2 * step}
        assert adamw_ops.launches == 2 * step
        gn = float(metrics["grad_norm"])
        assert abs(gn - float(gn_plain)) <= 1e-6 * float(gn_plain)
        assert (float(gn_plain) > run.grad_clip) == (grad_scale == 1.0)
        for n, p in params.items():
            assert p.data_ptr() == ptrs[n] and p.dtype == ADAMW_LEAVES[n][1]
            ulps = dtype_ulps(p, p_plain[n])
            assert int(ulps.max()) <= 1 and float((ulps == 0).float().mean()) >= 0.999, n
            for got, want, old, before in ((new.m[n], m_plain[n], state.m[n], m_old[n]),
                                           (new.v[n], v_plain[n], state.v[n], v_old[n])):
                assert got is not old and got.data_ptr() != old.data_ptr()
                assert got.shape == want.shape and got.dtype == torch.float32
                torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30)
                assert torch.equal(old, before)          # the old moments untouched
        state = new


def test_adamw_kernel_no_host_sync_and_same_bits_on_gpu(cuda):
    """``update`` through the kernel syncs nothing with the host, and two
    runs from the same state give the same norm, parameters and moments in
    every bit (the norm's partials are summed in one fixed order)."""
    from repro_torch.configs import RunConfig
    from repro_torch.optim import adamw
    run = RunConfig(learning_rate=1e-2, total_steps=10, warmup_steps=2, grad_clip=1.0)
    params, grads = adamw_leaves(cuda, 5, 1.0)
    state = adamw.init(params, run)
    start = {n: p.clone() for n, p in params.items()}
    adamw.update(grads, state, {n: p.clone() for n, p in params.items()}, run)   # warm-up
    torch.cuda.synchronize()
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        torch.cuda.set_sync_debug_mode("error")
        try:
            new, metrics = adamw.update(grads, state, params, run)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        runs.append((metrics["grad_norm"].clone(), {n: p.clone() for n, p in params.items()},
                     new))
    (gn_a, p_a, s_a), (gn_b, p_b, s_b) = runs
    assert torch.equal(gn_a, gn_b) and float(gn_a) > run.grad_clip
    for n in params:
        assert torch.equal(p_a[n], p_b[n]) and not torch.equal(p_a[n], start[n])
        assert torch.equal(s_a.m[n], s_b.m[n]) and torch.equal(s_a.v[n], s_b.v[n])


def test_adamw_kernel_takes_one_device_dtensors_on_gpu(cuda):
    """DTensor leaves of a 1 × 1 mesh (the ``optimized`` runs' parameters and
    ZeRO-1 moments) go through the kernel as their shards: the same step, in
    every bit, as the same leaves as plain tensors, and the new moments come
    back as DTensors with the old ones' placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import RunConfig
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    run = RunConfig(learning_rate=1e-2, total_steps=10, warmup_steps=2, grad_clip=1.0)
    params, grads = adamw_leaves(cuda, 6, 1.0)
    params = {n: p.contiguous() for n, p in params.items()}
    plain = {n: p.clone() for n, p in params.items()}
    mesh_mod.close_mesh()
    mesh = mesh_mod.make_local_mesh(1, 1, device=cuda)
    try:
        rep = {n: (Replicate(), Replicate()) for n in params}
        zero1 = {n: (Shard(0), Replicate()) for n in params}
        placed = {n: distribute(p, mesh, rep[n]) for n, p in params.items()}
        state = adamw.init(placed, run, shardings=zero1, mesh=mesh)
        adamw.reset()
        new, metrics = adamw.update({n: distribute(g, mesh, rep[n]) for n, g in grads.items()},
                                    state, placed, run)
        want, want_metrics = adamw.update(grads, adamw.init(plain, run), plain, run)
        torch.cuda.synchronize()
        assert adamw.snapshot() == {"fused_steps": 2, "plain_steps": 0,
                                    "plain_reason": None, "launches": 4}
        assert torch.equal(metrics["grad_norm"], want_metrics["grad_norm"])
        for n in params:
            assert torch.equal(placed[n].to_local(), plain[n])
            for got, old, ref in ((new.m[n], state.m[n], want.m[n]),
                                  (new.v[n], state.v[n], want.v[n])):
                assert got.placements == old.placements and got.device_mesh == mesh
                assert torch.equal(got.to_local(), ref) and not old.to_local().any()
    finally:
        mesh_mod.close_mesh()


# what the kernel has no instance for, on the card: (change to the leaves, error)
ADAMW_REFUSED = {
    "fp16_param": (lambda g, p, m, v: (g, [p[0].half(), *p[1:]], m, v), TypeError),
    "fp16_grad": (lambda g, p, m, v: ([g[0].half(), *g[1:]], p, m, v), TypeError),
    "bf16_moment": (lambda g, p, m, v: (g, p, [m[0].bfloat16(), *m[1:]], v), TypeError),
    "strided": (lambda g, p, m, v: (g, [p[0].t(), *p[1:]], m, v), ValueError),
    "on_cpu": (lambda g, p, m, v: (g, p, m, [v[0].cpu(), *v[1:]]), ValueError),
    "sizes": (lambda g, p, m, v: (g, p, [m[1], m[0], *m[2:]], v), ValueError),
}


@pytest.mark.parametrize("case", sorted(ADAMW_REFUSED))
def test_adamw_kernel_refuses_what_it_has_no_instance_for_on_gpu(cuda, case):
    """Leaves on the card never fall back to the plain loop: a dtype the
    kernel has no instance for raises TypeError; a strided leaf, one off the
    card among them, or a moment of another size raises ValueError."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    shapes = [(64, 32), (16,), (4, 8, 3)]
    g = [torch.randn(s, device=cuda, dtype=torch.bfloat16) for s in shapes]
    p = [torch.randn(s, device=cuda, dtype=torch.bfloat16) for s in shapes]
    m = [torch.zeros(s, device=cuda) for s in shapes]
    v = [torch.zeros(s, device=cuda) for s in shapes]
    assert adamw_ops.plain_reason(g, p, m, v) is None
    change, error = ADAMW_REFUSED[case]
    with pytest.raises(error):
        adamw_ops.plain_reason(*change(g, p, m, v))


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
