"""repro_torch.launch.serve end to end on the CPU, and the port's isolation.

The serving entry point runs the reduced qwen1.5-0.5b and mamba2-780m
through the kernels' plain versions and must print the reference's serving
lines: for qwen with a page-run coalescing dict equal to the reference
planner's on the same page table, for mamba2 (no pages) without that line;
then, beyond the reference's lines, the decode cache's ``snapshot()`` and
the decode steps' counts.
The port must import neither JAX nor the ``repro`` package.
On a GPU machine without JAX, the card's case runs with
``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_serve.py -k gpu``.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to parallel test workers

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.ring_attention import ops as ra  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import PagedKVPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU_ARGS = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "20",
            "--gen", "6", "--page-tokens", "4"]
SSM_ARGS = ["--arch", "mamba2-780m", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "64", "--gen", "6"]


def test_serve_prints_the_reference_lines(capsys):
    ref_ops = pytest.importorskip("repro.kernels.paged_attention.ops")
    res = serve.main(CPU_ARGS)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SERVING DONE"
    assert re.fullmatch(r"prefill 20 tokens × 3 seqs in [0-9.]+s", out[0])
    assert re.fullmatch(r"decode 6 steps × 3 seqs: [0-9.,]+ tok/s", out[1])
    ids = ast.literal_eval(out[2].removeprefix("sample continuation token ids: "))
    assert ids == res.generated[0].tolist()
    stats = ast.literal_eval(out[3].removeprefix("page-run coalescing: "))
    # 26 tokens in pages of 4: 7 contiguous pages a sequence, blocks of 4 + 3
    assert res.cache.page_table.shape == (3, 7)
    assert stats == ref_ops.descriptor_stats(res.cache.page_table, 4)
    assert stats == {"pages": 21, "descriptors": 6, "reduction": 3.5}
    # greedy: each step's token is the argmax of the step before
    vocab = res.model.cfg.vocab_size
    greedy = res.decode_logits[:, :, :vocab].argmax(-1).numpy()
    np.testing.assert_array_equal(res.generated, greedy)
    np.testing.assert_array_equal(res.fed[:, 1:].numpy(), greedy[:, :-1])
    assert torch.isfinite(res.decode_logits.float()).all()


def test_serve_ssm_prints_the_reference_lines(capsys):
    """Reduced mamba2: prefill over two chunks of 32, then 6 greedy steps of
    the recurrent decode. The SSM has no pages, so, as in the reference
    (which prints it only under --spill), there is no page-run line."""
    res = serve.main(SSM_ARGS)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and out[-1] == "SERVING DONE"
    assert re.fullmatch(r"prefill 64 tokens × 2 seqs in [0-9.]+s", out[0])
    assert re.fullmatch(r"decode 6 steps × 2 seqs: [0-9.,]+ tok/s", out[1])
    ids = ast.literal_eval(out[2].removeprefix("sample continuation token ids: "))
    assert ids == res.generated[0].tolist()
    snaps = ast.literal_eval(out[3].removeprefix("decode cache after the last step: "))
    assert snaps == {"SSMCache": res.cache.snapshot()}
    steps = ast.literal_eval(out[4].removeprefix("decode steps: "))
    assert steps == {"replays": 0, "captures": {}, "eager": {"cpu device": 6}}
    assert res.cache.h.shape == (2, 2, 4, 16, 32)       # (L, B, H, N, P)
    vocab = res.model.cfg.vocab_size
    greedy = res.decode_logits[:, :, :vocab].argmax(-1).numpy()
    np.testing.assert_array_equal(res.generated, greedy)
    np.testing.assert_array_equal(res.fed[:, 1:].numpy(), greedy[:, :-1])
    assert torch.isfinite(res.decode_logits.float()).all()


def test_serve_ssm_refuses_a_prompt_off_the_chunk(capsys):
    with pytest.raises(SystemExit):
        serve.main(SSM_ARGS[:-4] + ["--prompt-len", "40", "--gen", "2"])
    assert "seq_len must be a multiple of ssm_chunk" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--donors", "3"], ["--clients", "2"],
                                   ["--straggler", "1:30"]])
def test_serve_fabric_flags_need_spill(flags, capsys):
    """The reference's rule (src/repro/launch/serve.py): the fabric flags
    only take effect with --spill, and say so."""
    with pytest.raises(SystemExit):
        serve.main(CPU_ARGS + flags)
    assert ("fabric flags (--donors/--clients/--replication/--link-*/"
            "--straggler) only take effect with --spill") in capsys.readouterr().err


def test_serve_spill_prints_the_reference_lines(capsys):
    """--spill on the CPU: a kv_store on the device takes one row a
    sequence and step, sequence 0 spills and comes back byte-exact while a
    second client pages to the same donors, and the lines are the
    reference's, with page-run coalescing equal to its planner's."""
    ref_ops = pytest.importorskip("repro.kernels.paged_attention.ops")
    res = serve.main(CPU_ARGS + ["--spill", "--donors", "3", "--replication", "2",
                                 "--clients", "2", "--straggler", "1:30"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SERVING DONE" and len(out) == 8
    sp = res.spill
    kv = sp.kv
    assert kv.pool.device == torch.device("cpu")
    # 6 decode steps × 3 sequences of one row each, appended in turn:
    # pages of 4 tokens interleave, 2 pages a sequence
    assert [kv.lengths[b] for b in range(3)] == [6, 6, 6]
    assert sp.table.tolist() == [[0, 3], [1, 4], [2, 5]]
    stats = ast.literal_eval(out[3].removeprefix("page-run coalescing: "))
    assert stats == ref_ops.descriptor_stats(sp.table, 4)
    assert stats == {"pages": 6, "descriptors": 6, "reduction": 1.0}
    assert re.fullmatch(r"spill/fetch: \d+ RDMA ops, merge drains \d+", out[4])
    ops, drains = map(int, re.findall(r"\d+", out[4]))
    assert ops == sp.stats["nic"]["0"]["rdma_ops"] and ops >= 2
    assert drains == sp.stats["client"]["0"]["box"]["merge"]["drains"]
    assert out[5].startswith("background clients (pages/s under contention): {1: ")
    service = ast.literal_eval(out[6].removeprefix("donor-side per-client service: "))
    assert set(service) == {2, 3, 4} and all(1 in v for v in service.values())
    assert sum(v[1]["ops"] for v in service.values()) == 2 * 64   # r 2 × 64 pages
    assert torch.equal(kv.gather(0), sp.seq0_before)
    assert kv.gather(0).shape == (6, serve.KV_FEATURES)


def test_serve_on_gpu_goes_through_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fa.launches = pa.launches = 0
    res = serve.main(["--reduced", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    layers = res.model.cfg.num_layers
    assert (fa.launches, pa.launches) == (layers, layers * 4)
    assert torch.isfinite(res.decode_logits.float()).all()


def test_serve_ssm_on_gpu_goes_through_the_scan_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fa.launches = pa.launches = ssd.launches = 0
    res = serve.main(["--arch", "mamba2-780m", "--reduced", "--batch", "2",
                      "--prompt-len", "64", "--gen", "4"])
    assert (ssd.launches, fa.launches, pa.launches) == (res.model.cfg.num_layers, 0, 0)
    assert torch.isfinite(res.decode_logits.float()).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_every_arch_on_cpu(arch, capsys):
    """``--arch <id> --reduced --device cpu`` serves every arch of the
    registry: the reference's lines, a greedy continuation for token archs
    (none for a frontend's embeddings), the page-run line only over a paged
    cache, and no kernel launch on the CPU."""
    cfg = get_reduced(arch)
    fa.launches = pa.launches = ssd.launches = ra.launches = 0
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4", "--page-tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SERVING DONE"
    assert re.fullmatch(r"prefill 16 tokens × 2 seqs in [0-9.]+s", out[0])
    assert re.fullmatch(r"decode 4 steps × 2 seqs: [0-9.,]+ tok/s", out[1])
    assert any(ln.startswith("sample continuation") for ln in out) == (not cfg.frontend)
    assert any(ln.startswith("page-run coalescing") for ln in out) == isinstance(
        res.cache, PagedKVPool)
    assert isinstance(res.cache, PagedKVPool) == (
        cfg.uses_attention and cfg.attention == "gqa" and cfg.window is None)
    if cfg.frontend:
        assert res.generated is None and res.prompts.shape == (2, 16, cfg.d_model)
        assert res.fed.shape == (2, 4, cfg.d_model)
    else:
        greedy = res.decode_logits[:, :, :cfg.vocab_size].argmax(-1).numpy()
        np.testing.assert_array_equal(res.generated, greedy)
    assert res.decode_logits.shape == (2, 4, cfg.padded_vocab)
    assert torch.isfinite(res.decode_logits.float()).all()
    assert (fa.launches, pa.launches, ssd.launches, ra.launches) == (0, 0, 0, 0)


# reduced archs the kernels take (deepseek's reduced head dim 48 is CPU-only):
# arch → (flash, paged, ssd_scan, ring) launches for 2 layers, 4 decode steps
GPU_ARCHS = {"rdmabox-paper-100m": (2, 8, 0, 0), "musicgen-large": (2, 8, 0, 0),
             "qwen2-moe-a2.7b": (2, 8, 0, 0), "hymba-1.5b": (2, 0, 2, 8)}


@pytest.mark.parametrize("arch", sorted(GPU_ARCHS))
def test_serve_arch_on_gpu_goes_through_its_kernels(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fa.launches = pa.launches = ssd.launches = ra.launches = 0
    res = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "64",
                      "--gen", "4"])
    assert (fa.launches, pa.launches, ssd.launches, ra.launches) == GPU_ARCHS[arch]
    assert torch.isfinite(res.decode_logits.float()).all()


def test_serve_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


ISOLATION = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
print("LEAKED", bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", ISOLATION], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LEAKED []"
    sources = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
               ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
