"""repro_torch's latent attention (MLA's absorbed decode over the latent cache).

On the CPU the wrapper runs its plain version, which is the einsum path
``mla_decode`` ran before the kernel, op for op: held to it bit for bit, and
to the f64 oracle. The meta op's shapes and counts, the split count and the
instances are checked here too. The CUDA kernel runs only on a GPU: those
cases skip here (no JAX is imported, so they run on the card's machine)::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_latent_attention.py -k gpu
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch.configs import get_reduced, replace  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_16b import PUBLISHED  # noqa: E402
from repro_torch.distributed.sharding import split_last  # noqa: E402
from repro_torch.kernels.latent_attention import ops as la  # noqa: E402
from repro_torch.kernels.latent_attention.ref import latent_attention_ref  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402
from repro_torch.models.layers import softmax_scale  # noqa: E402

CPU = torch.device("cpu")
# the reduced registry copy with the release's YaRN (its m² in the scale)
YARN = dict(yarn_factor=40.0, yarn_original_max_pos=4096, yarn_beta_fast=32.0,
            yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def reduced_cfg(yarn: bool):
    cfg = get_reduced("deepseek-v2-lite-16b")
    return replace(cfg, **YARN) if yarn else cfg


def einsum_path(p, x, cfg, cache, layer, plan):
    """``mla_decode``'s body before the kernel (an unsharded cache), as it was."""
    from repro_torch.models.mla import _mla_qkv
    B = x.shape[0]
    H, R = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe, c_new, kpe_new = _mla_qkv(p, x, cfg, plan.positions)
    cache.write_step(layer, plan, c_new[:, 0], kpe_new[:, 0])
    c_kv, k_pe, valid = cache.c_kv[layer], cache.k_pe[layer], plan.valid
    c_kv, k_pe = c_kv.float(), k_pe.float()
    wk_b = split_last(p.wk_b, H, dn).float()
    wv_b = split_last(p.wv_b, H, dv).float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk_b)
    s = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
    s = s + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), k_pe)
    s = s * softmax_scale(cfg, dn + dr)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c_kv)
    out = torch.einsum("bhr,rhd->bhd", o_lat, wv_b)
    return out.reshape(B, 1, H * dv).to(x.dtype) @ p.wo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("yarn", [False, True])
@torch.no_grad()
def test_mla_decode_equals_the_einsum_path_bit_for_bit(yarn, dtype):
    """At the reduced shapes, a latent cache holding other tokens and each
    sequence at another position (one at slot 0, one at the last slot):
    ``mla_decode`` through ``latent_attention`` on the CPU gives the einsum
    path's output and cache in every bit, through the argument checks the
    card's route takes, and counts no kernel or sharded call."""
    cfg = reduced_cfg(yarn)
    torch.manual_seed(0)
    p = mla.MLA(cfg, device=CPU).to(dtype)
    for t in p.parameters():
        t.normal_(0, 0.2)
    B, S = 3, 24
    caches = [mla.LatentCache(cfg, B, S, device=CPU, dtype=dtype) for _ in range(2)]
    gen = torch.Generator().manual_seed(1)
    for buf in caches[0].bufs:
        buf.copy_(torch.randn(buf.shape, generator=gen).to(dtype))
    for a, b in zip(caches[0].bufs, caches[1].bufs):
        b.copy_(a)
    x = torch.randn(B, 1, cfg.d_model, generator=gen).to(dtype)
    cur = np.array([0, 9, S - 1])
    before = mla.decode_routes()
    y = mla.mla_decode(p, x, cfg, caches[0], 1, caches[0].plan_step(cur))
    after = mla.decode_routes()
    y_ref = einsum_path(p, x, cfg, caches[1], 1, caches[1].plan_step(cur))
    assert y.dtype == dtype and torch.equal(y, y_ref)
    for a, b in zip(caches[0].bufs, caches[1].bufs):
        assert torch.equal(a, b)
    assert {k: after[k] - before[k] for k in after} == {"kernel": 0, "sharded": 0}


def test_every_route_checks_the_arguments():
    """The wrapper's contract holds on the CPU as on the card: ``mla_decode``'s
    absorbed query, an einsum batched over heads, is a (b, h, r) view the
    kernel cannot read, and the wrapper refuses it, a mismatched shape, a
    non-bool mask, a mixed dtype and a misaligned cache on every device."""
    gen = torch.Generator().manual_seed(3)
    B, H, R, dr, S, dn = 3, 4, 32, 16, 24, 8
    q_nope = torch.randn(B, H, dn, generator=gen)
    wk_b = torch.randn(R, H, dn, generator=gen)
    q_view = torch.einsum("bhd,rhd->bhr", q_nope, wk_b)
    assert not q_view.is_contiguous()
    q_pe, c_kv, k_pe = (torch.randn(*s, generator=gen).bfloat16()
                        for s in ((B, H, dr), (B, S, R), (B, S, dr)))
    valid = torch.ones(B, S, dtype=torch.bool)
    with pytest.raises(ValueError, match="contiguous"):
        la.latent_attention(q_view, q_pe, c_kv, k_pe, valid, 0.1)
    out = la.latent_attention(q_view.contiguous(), q_pe, c_kv, k_pe, valid, 0.1)
    assert out.shape == (B, H, R)
    with pytest.raises(ValueError, match="q_lat"):
        la.latent_attention(q_view.contiguous()[:2], q_pe, c_kv, k_pe, valid, 0.1)
    with pytest.raises(ValueError, match="valid must be bool"):
        la.latent_attention(q_view.contiguous(), q_pe, c_kv, k_pe, valid.float(), 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        la.latent_attention(q_view.contiguous(), q_pe.float(), c_kv, k_pe, valid, 0.1)
    flat = torch.zeros(B * S * R + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        la.latent_attention(q_view.contiguous(), q_pe, flat[4:].view(B, S, R), k_pe, valid,
                            0.1)
    meta = [t.to("meta") for t in (q_view, q_pe, c_kv, k_pe, valid)]
    with pytest.raises(ValueError, match="contiguous"):
        la.latent_attention(*meta, 0.1)


@pytest.mark.parametrize("R, dr", la.INSTANCES)
def test_plain_version_against_the_f64_oracle(R, dr):
    """The plain f32 version on a latent cache's mask (slots ≤ cur) within
    f32 rounding of the f64 oracle on the positions alone."""
    gen = torch.Generator().manual_seed(2)
    B, H, S = 3, 16, 40
    cur = torch.tensor([0, 17, S - 1])
    valid = torch.arange(S)[None, :] <= cur[:, None]
    q_lat = torch.randn(B, H, R, generator=gen)
    q_pe, c_kv, k_pe = (torch.randn(*shape, generator=gen).bfloat16()
                        for shape in ((B, H, dr), (B, S, R), (B, S, dr)))
    scale = softmax_scale(PUBLISHED, 192)
    out = la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, scale)
    assert out.dtype == torch.float32 and out.shape == (B, H, R)
    ref = latent_attention_ref(q_lat, q_pe, c_kv, k_pe, cur, scale)
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() < 1e-5
    # at the slot-0 sequence the output is that slot's latent for every head
    torch.testing.assert_close(out[0], c_kv[0, 0].float().expand(H, R), rtol=0, atol=0)


def test_meta_op_counts_every_slot():
    """On meta tensors: o_lat's shape and dtype, the kernel's flops (scores
    against the latent and the rope key, the output over the latent, every
    slot) and bytes (q_lat, q_pe, the cache, the mask, o_lat)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import BYTES
    B, H, R, dr, S = 64, 16, 512, 64, 2560
    meta = torch.device("meta")
    q_lat = torch.empty(B, H, R, device=meta)
    q_pe = torch.empty(B, H, dr, dtype=torch.bfloat16, device=meta)
    c_kv = torch.empty(B, S, R, dtype=torch.bfloat16, device=meta)
    k_pe = torch.empty(B, S, dr, dtype=torch.bfloat16, device=meta)
    valid = torch.empty(B, S, dtype=torch.bool, device=meta)
    with FlopCounterMode(display=False) as fc:
        out = la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, 0.1)
    assert out.shape == (B, H, R) and out.dtype == torch.float32 and out.device.type == "meta"
    assert fc.get_total_flops() == 2 * B * H * S * (2 * R + dr) == 5_704_253_440
    nbytes = BYTES[torch.ops.repro_torch.latent_attention](q_lat, q_pe, c_kv, k_pe, valid, 0.1,
                                                           result=out)
    assert nbytes == (2 * B * H * R * 4 + B * H * dr * 2 + B * S * (R + dr) * 2 + B * S)
    assert B * S * (R + dr) * 2 == 188_743_680          # the cache: 189 MB a layer
    with pytest.raises(NotImplementedError, match="meta tensors only"):
        torch.ops.repro_torch.latent_attention(
            torch.zeros(1, 2, 32), torch.zeros(1, 2, 16), torch.zeros(1, 4, 32),
            torch.zeros(1, 4, 16), torch.ones(1, 4, dtype=torch.bool), 0.1)


def test_split_count_follows_the_grid_the_length_and_the_sms_alone():
    """The grid spans one and a half waves of one CTA an SM over the
    (sequence, 16 heads) pairs, at least 256 slots each, at most 16,384,
    never a trailing split without a slot; the same arguments give the same
    count, whatever a step's lengths."""
    assert la.split_count(64, 2560, 132) == 3                # deepseek-v2-lite-16b.decode
    assert 64 * 3 <= 1.5 * 132 < 64 * 4
    assert la.split_count(4, 2560, 132) == 10                # capped by 256 slots a split
    assert la.split_count(200, 2560, 132) == 1               # the pairs alone fill the waves
    assert la.split_count(4, 96, 132) == 1                   # too short to split
    assert la.split_count(264, 2560, 132) == 1               # the grid fills the card
    assert la.split_count(64, 100_000, 8) == 7               # 16,384 slots a split at most
    for ctas, length in ((3, 1000), (7, 513), (2, 300), (64, 2560)):
        S = la.split_count(ctas, length, 132)
        per = -(-length // S)
        assert (S - 1) * per < length <= S * per <= length + per - 1
        assert S == la.split_count(ctas, length, 132)


def test_kernel_takes_only_its_instances():
    """``kernel_takes`` names the instances ((R, dr) in INSTANCES, q_lat f32,
    q_pe and the cache of one dtype, bf16 or f32): on the card any other input
    raises. On the CPU every input runs the plain version."""
    bf16, f32 = torch.bfloat16, torch.float32

    def takes(R, dr, dtype=bf16, q_dtype=f32, pe_dtype=None):
        return la.kernel_takes(torch.zeros(2, 4, R, dtype=q_dtype),
                               torch.zeros(2, 4, dr, dtype=pe_dtype or dtype),
                               torch.zeros(2, 8, R, dtype=dtype), torch.zeros(2, 8, dr,
                                                                              dtype=dtype))
    for R, dr in la.INSTANCES:
        assert takes(R, dr) and takes(R, dr, f32)
    for R, dr in ((512, 32), (256, 64), (32, 64), (64, 16), (128, 16)):
        assert not takes(R, dr)
    assert not takes(512, 64, q_dtype=bf16)                 # q_lat not f32
    assert not takes(512, 64, pe_dtype=f32)                 # q_pe not the cache's dtype
    assert not takes(512, 64, torch.float16)
    gen = torch.Generator().manual_seed(0)
    q_lat = torch.randn(2, 4, 48, generator=gen)
    q_pe, c_kv, k_pe = (torch.randn(*s, generator=gen).bfloat16()
                        for s in ((2, 4, 8), (2, 8, 48), (2, 8, 8)))
    valid = torch.ones(2, 8, dtype=torch.bool)
    torch.testing.assert_close(la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, 0.2),
                               la.latent_attention_plain(q_lat, q_pe, c_kv, k_pe, valid, 0.2),
                               rtol=0, atol=0)


def test_serve_prints_the_latent_routes(capsys):
    """The reduced MLA arch served on the CPU: every decode layer's call takes
    the plain version, neither counted route, and serve prints the counts."""
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    cfg = get_reduced("deepseek-v2-lite-16b")
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("latent decode calls:"))
    assert cfg.num_layers > 0
    assert line == "latent decode calls: {'kernel': 0, 'sharded': 0}"


def test_kernel_at_the_cell_shape_on_gpu(cuda):
    """deepseek-v2-lite-16b.decode's latent cache in one layer (B 64, 2,560
    slots, lengths 1 to 2,560): the kernel serves the call, the same bits
    twice, within chip_smoke.LATENT_TOL of the f64 oracle, and the bf16 faults
    read past it."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    q_lat, q_pe, c_kv, k_pe, valid, lengths = chip_smoke.latent_decode_inputs(cuda, gen)
    scale = chip_smoke.latent_scale()
    before = la.launches
    out = la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, scale)
    again = la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, scale)
    torch.cuda.synchronize()
    assert la.launches == before + 2 and torch.equal(out, again)
    errs = chip_smoke.latent_errors(out, q_lat, q_pe, c_kv, k_pe, valid, lengths, scale)
    assert errs["kernel"] <= chip_smoke.LATENT_TOL
    assert min(errs["fault_q_lat_bf16"], errs["fault_p_bf16"]) > chip_smoke.LATENT_TOL


def test_kernel_edge_cases_on_gpu(cuda):
    """Both instances in bf16 and f32, H 20, one valid slot, B 1, empty
    splits, a mask with holes, a cache view (chip_smoke.py's cases): the same
    bits twice, within LATENT_TOL."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(0)
    dtypes = set()
    for case in chip_smoke.latent_edge_cases(cuda, gen):
        before = la.launches
        row = chip_smoke.check_latent_case(case, chip_smoke.latent_scale())
        dtypes.add(row["dtype"])
        assert la.launches == before + 2
    assert dtypes == {"torch.bfloat16", "torch.float32"}


def test_other_inputs_raise_on_gpu(cuda):
    """Mixed dtypes, f16, a bf16 q_lat, and (R, dr) with no instance raise and
    launch nothing."""
    valid = torch.ones(2, 16, dtype=torch.bool, device=cuda)
    bad = ((torch.float32, torch.bfloat16, torch.float32, 512, 64, TypeError),
           (torch.float32, torch.float16, torch.float16, 512, 64, TypeError),
           (torch.bfloat16, torch.bfloat16, torch.bfloat16, 512, 64, TypeError),
           (torch.float32, torch.bfloat16, torch.bfloat16, 256, 64, ValueError),
           (torch.float32, torch.bfloat16, torch.bfloat16, 512, 32, ValueError))
    for q_dtype, pe_dtype, c_dtype, R, dr, err in bad:
        q_lat = torch.randn(2, 16, R, device=cuda).to(q_dtype)
        q_pe = torch.randn(2, 16, dr, device=cuda).to(pe_dtype)
        c_kv = torch.randn(2, 16, R, device=cuda).to(c_dtype)
        k_pe = torch.randn(2, 16, dr, device=cuda).to(c_dtype)
        before = la.launches
        with pytest.raises(err, match="latent_attention"):
            la.latent_attention(q_lat, q_pe, c_kv, k_pe, valid, 0.1)
        assert la.launches == before
