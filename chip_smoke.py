#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every ``src/repro_torch/csrc/*.cu`` (flash attention forward and
   backward, paged attention, ring attention, the SSD scan forward and backward,
   AdamW) with nvcc for sm_90a, one nvcc per source, all started together;
3. model: the analytic backend's calibration against the threaded engine
   (``repro_torch.model.run_calibration``) at the reference suite's point, 4
   clients, 2 donors, 1 worker, paced 1-page writes, with the clients' buffers
   on the card: model/measured throughput and mean latency within ±0.35, no
   predicted saturation, no admission shrink; the same point once more on
   CPU buffers beside it, held the same way; the real time of one engine
   write from each device. A wall-clock measurement, so it runs first, in a
   process that has served no model yet;
4. examples: the four example twins (``repro_torch.examples``) with
   ``--device cuda``, in this process, each ending on its OK line;
   ``serve_paged`` (reduced qwen1.5-0.5b, --spill) launches flash and paged
   attention; ``capacity_plan`` starts no thread and prints the same plan as
   on the CPU;
5. kernels vs plain: each CUDA kernel against its plain PyTorch version on the
   card, at the reference suite's shapes and at the serving shapes (flash
   attention also at a causal prompt of 4096 tokens, at deepseek's prefill at
   head dim 192 and at hymba's, GQA 25/5 with a 1024-token window; paged
   attention also at qwen2-moe's and qwen2.5-32b's decode, D 128, at its edge
   cases (GQA groups 1, 2, 5, 7 and 8) and at 8192 tokens of context; ring
   attention at hymba-1.5b.decode's ring (B 64, 1024 slots, GQA 25/5) in bf16
   and f32 and at its edge cases (each instance's (D, G) in both dtypes, one
   valid slot, B 1, empty splits, valid slots across the ring's end), each run
   twice, equal bits, within a bf16 ulp (f32: PAGED_TOL's); the scan
   also at hymba's prefill, 50 heads, N 16); the flash backward and the
   forward's LSE at the reference suite's shapes, the training shape,
   qwen1.5-0.5b's heads, hymba's window, deepseek's D 192, and at S 512 and D
   128 qwen2-moe-a2.7b's heads and the GQA groups 5, 7 and 8 of qwen2.5-32b,
   llava-next-34b and command-r-35b, in f32 and bf16, the backward run twice
   and held to equal bits; the scan's
   training forward (cs summed in f64; y, h_final and the chunk-entry states
   against the plain version's) and its backward at the reference suite's scan
   shapes, ragged tiles and the training shapes of mamba2-780m and hymba-1.5b,
   with and without h_final's cotangent, held to 1e-4 and to equal bits;
   then ``latent``: the latent attention kernel at deepseek-v2-lite-16b.decode's
   latent cache (B 64, 2,560 slots, lengths 1 to 2,560) and at its edge cases
   (both instances in bf16 and f32, H 20, one valid slot, B 1, empty splits, a
   mask with holes, a cache view), each run twice, equal bits, a CUDA graph's
   replay equal to the eager call, o_lat within LATENT_TOL of an f64 oracle
   beside the plain f32 version's error, q_lat or P rounded once to bf16 read
   past LATENT_TOL; and ``latent_served``: the deepseek-v2-lite-16b.decode
   cell for a few seconds through the benchmark's harness, its served tokens
   held to the plain reference's ``served_gap`` limit;
6. serve: ``repro_torch.launch.serve.main`` at full width (qwen1.5-0.5b, batch 4,
   prompt 64, 32 decode steps) with every kernel's launch count reset just
   before and read just after; the decode logits against one forward pass over
   prompt + generated tokens;
7. serve_ssm: the same for mamba2-780m at full width (batch 4, prompt 512 = two
   scan chunks of 256, 256 decode steps), through the SSD chunk-scan kernel;
8. ssm_f32: the decode-vs-forward bound for mamba2 on an f32 copy of the served
   weights, over the served tokens (in bf16 the random full-width model
   amplifies rounding past the bound, the JAX reference as much as the port);
9. serve_spill: qwen1.5-0.5b at full width again, with ``--spill --donors 3
   --replication 2 --clients 2``: the ``kv_store`` on the card, donor memory
   pinned on the host; sequence 0's gather byte-exact after its spill and fetch,
   the same kernel launches as ``serve``, no failed transfer, struck donor or
   disk access;
10. kv_spill: a long-context pool through the RDMAbox engine: qwen1.5-0.5b's
   per-layer K/V (2·16·64 bf16 features, 4 KB a token) for 4 sequences of 8192
   tokens in pages of 16 (2048 + 3 pages, 128 MiB on the card) held as a
   ``kv_store``; paged attention over it, every sequence spilled to 3 donors
   and fetched back, paged attention again; spill and fetch rates beside one
   plain ``copy_`` of the same bytes to pinned memory and back;
11. serve_archs: ``serve.main`` at full width and depth for every other arch
   of the registry (rdmabox-paper-100m, musicgen-large with embedding inputs,
   qwen2-moe-a2.7b, hymba-1.5b with a prompt of 1280 past its 1024-token
   window, deepseek-v2-lite-16b through flash at D 192, and command-r-35b,
   qwen1.5-32b, qwen2.5-32b and llava-next-34b (embedding inputs): 64.8-70.4
   GB of bf16 weights beside init_weights' one f32 draw, ``serve_bytes``),
   B 4, prompt 64, 32 steps, each kernel's launches reset just before and
   held to the arch's count just after; peak memory beside the reckoning;
12. dense_decode: the four 32-35 B archs at full width, depth cut to 2
   layers, prefill of 64 and 32 decode steps against one forward (paged
   attention at GQA groups 8, 1, 5 and 7, D 128), held in f32 as hymba is;
13. hybrid_decode: hymba at full width, prefill of 1280, 256 decode steps across
   the ring's wrap, against one forward; held in f32, beside it bf16 through
   the kernels and bf16 with flash and the scan swapped for their plain
   versions, and each bf16 forward against the f32 one;
14. mla_decode: deepseek at full width with every expert routed, prefill of 32
   tokens and 32 absorbed decode steps against one forward; held and witnessed
   as hymba is;
15. train: ``repro_torch.launch.train.main`` at full width (rdmabox-paper-100m,
   batch 8, sequence 512, 30 steps, --offload of the first moment through the
   engine), launches reset just before and held to 12 flash forwards, 12
   flash backwards and 2 AdamW launches (the norm, then every leaf's update) a
   step just after (every training phase holds AdamW's 2 a step, but
   ``train_grads``, which takes no step; ``optimized``'s DTensor parameters
   take the kernel too, as their shards), the loss finite at every step and the
   mean of the last 5 below the first 5's by 0.1; step seconds, train tok/s,
   peak device memory; then 2 steps with --remat full (24 forwards a step);
16. train_ssm: ``launch.train.main`` at full width and depth on mamba2-780m
   (batch 8, sequence 512 = two scan chunks, 30 steps), launches held to 48
   scan forwards and 48 scan backwards a step and nothing else, the loss
   finite and falling by 0.1 as in ``train``; step seconds, train tok/s, peak
   device memory;
17. train_archs: 30 steps of ``launch.steps.build_train_step`` at S 512, real
   top-k routing, no checkpoint: qwen2-moe-a2.7b and deepseek-v2-lite-16b at
   4 layers, musicgen-large at full depth on codebook embeddings
   (``frontend_embeds``), B 4; the loss finite at every step and falling by
   0.1, one flash forward and backward an attention layer a step; step
   seconds, train tok/s, peak memory;
18. train_grads: one step at full width, S 512, of every arch: rdmabox-paper-100m
   (B 8), qwen1.5-0.5b, mamba2-780m, hymba-1.5b, musicgen-large (embedding
   inputs, its untied embed unreached) at full depth, and qwen2-moe-a2.7b,
   deepseek-v2-lite-16b (B 4), llava-next-34b (embedding inputs),
   command-r-35b, qwen1.5-32b and qwen2.5-32b (B 2) at 2 layers; every
   parameter's gradient through the kernels against the gradient with flash's
   and the scan's plain versions swapped in on the card: held on an f32 copy
   (finite, nonzero, relative norm error ≤ 1e-4; a MoE arch routes every
   token to every expert there, command-r-35b's kernel gradients wait in host
   memory), printed in bf16 (held finite; real top-k), each arch's launches
   held;
19. moe_repeat: qwen2-moe-a2.7b at full width, depth cut to 2 of 24 layers,
   B 4, S 512: two forwards and backwards of the loss, the loss and every
   gradient equal in every bit (the MoE combine sums in a fixed order);
20. train_resume: rdmabox-paper-100m's width at 2 layers, 6 straight steps
   against 3 + a checkpoint restore + 3, every parameter and moment equal;
21. kernels: each kernel's time at the serving shapes (CUDA-graph replay, so no
   host gaps), its plain version's, the bound of the card, and a library call's;
   flash attention also at a causal prompt of 4096 tokens (D 64 and D 192), at
   deepseek's and hymba's prefill and at the training shape (with the LSE), the
   flash backward at the training shape, at qwen1.5-0.5b's heads (train_grads'
   shape), at head dim 192 and at qwen2-moe-a2.7b's training shape (D 128;
   library: SDPA's backward), paged attention also at qwen2-moe's and
   qwen2.5-32b's (G 5) decode and at 8192 tokens of context (planned
   at R = 4 and R = 1) and at several split counts, ring attention at
   hymba-1.5b.decode's ring (library: SDPA with ``enable_gqa`` and the boolean
   mask) and at 1 to 16 splits at B 64 and at B 4, the scan also at hymba's
   prefill, the scan's training forward (y in f32 on the CUDA cores, the
   state sweep on the FP64 tensor cores) and backward (FP64 tensor cores)
   at mamba2-780m's training shape (B 8, S 512), the backward also at
   hymba-1.5b's N 16 (B 4); the scan's training rows give the bound at 3×TF32
   and at the FP64 tensor cores they run; the scan's three kernels also at
   chunks 64 and 128 (phase 23); AdamW's two launches at hymba-1.5b's 611
   leaves (1.64 B bf16 parameters and gradients, f32 moments), one step held
   to the plain loop's (the norm within 1e-6, parameters equal on 99.9 % and
   one bf16 step apart elsewhere, moments within 2e-6), timed beside the plain
   loop's step and PyTorch's ``_foreach_norm`` + ``_fused_adamw_`` on the
   same leaves;
22. steps: ``launch.steps``' step builders on a real 1×1 ``DeviceMesh``
   (``make_local_mesh``, nccl) at full width, random weights from seed 0,
   the reference's dry-run shapes cut to one card (``STEP_RUNS``):
   qwen1.5-0.5b ``prefill_32k`` (flash) and ``decode_32k`` over a 32768-token
   paged cache (paged attention), mamba2-780m ``prefill_32k`` (the scan),
   mamba2-780m and hymba-1.5b ``long_500k`` (8 decode steps each); each run's
   host seconds around work that ends in a sync, the port's own roofline
   bound for the same cut shape on one card (``launch.dryrun.roofline_of``,
   counted on meta with the H100's constants), the share of that bound,
   kernel launches (held above zero for the kernel named) and peak memory.
   Each run's kernel once more on the inputs of its last launch in the step
   (a 32768-token causal prompt for flash, the 32768-token pool at B 4 for
   paged attention, 128 chunks of mamba2's 48 heads for the scan) against its
   plain version at ``kernels_vs_plain``'s tolerance; then, on an f32 copy of
   the weights, the prefill step's logits against ``Transformer.prefill``
   and every decode step's against the same steps, each with the plain
   versions swapped in (``plain_kernels``), held to 0.05. The two
   ``long_500k`` decodes name no kernel (the SSM state is plain torch in both
   packages; hymba's ring kernel is held in ``hybrid_decode``): their logits
   are held finite and of the vocabulary's width, and ``hybrid_decode`` and
   ``serve_ssm`` hold the same decode code against a forward;
23. optimized: the reference's perf knobs (``repro_torch.configs.optimized``)
   on the card. qwen2-moe-a2.7b and deepseek-v2-lite-16b at full width and
   ``train_arch_cfg``'s 4 layers under ``moe`` and ``mla_lat`` alone and
   under the port's ``optimize(cfg)`` (a variant whose config equals an
   earlier one's is named with it and not run again), their parameters
   DTensors on a 1×1 mesh (``make_local_mesh``, nccl) as the sharding rules
   place them, so that the knobs' own code runs on the card (the shard-local
   MoE dispatch and its reduction over "model"; MLA's latent scores as a
   partial sum reduced once): through the step builders a prefill of 64
   tokens (B 4), 8 decode steps and one train step (S TRAIN_SEQ), the flash
   and paged launches of each held and the host seconds printed. In f32,
   each variant's prefill and decode logits at 4 layers, and one train
   step's loss and gradient norm (``build_train_step``'s metrics) at 2
   layers, held to the unknobbed run's within 1e-5 (relative), and whether
   the bits are equal (on one model shard the shard-local dispatch is the
   global one). Then mamba2-780m at full width under ``ssd_chunk`` (64) and
   ``ssd_chunk128`` (128): a prefill of 512 tokens and one train step through
   the step builders, 48 scan forwards (and 48 backwards in training) held;
   the serving scan at the serving shape against ``ssd_chunked`` (1e-3), the
   training forward and the backward at ``train_ssm``'s shape against their
   plain versions (1e-4), each a row of the kernels line (phase 21) with its
   time, bound and launches;
24. moe_train: the published DeepSeek-V2-Lite stage's training pieces at the
   benchmark's ``deepseek-v2-lite-5l.train`` shape (B 2 × S 4096): the flash
   backward's row at H 16, D 192 (timed and held as phase 21's rows, one a
   layer, 5 a step), and one MoE layer of the stage (64 experts, top-6, 768
   rows an expert) forward and backward under the profiler: the grouped-GEMM
   kernels (``GroupProblemShape``, the pattern ``expert_gemm_roofline.train``
   reads) held to nine, their device ms beside the nine products' bound, the
   other kernels named like them printed, and two forwards and backwards of
   the layer equal in every bit.

Each phase's seconds are printed as it ends and gathered in a ``phase_seconds``
line. The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero; without a CUDA device it fails before printing
anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import box  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.buffers import copy_parts  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adamw import ops as aw  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_ref, flash_attention_online)
from repro_torch.kernels.latent_attention import ops as la  # noqa: E402
from repro_torch.kernels.latent_attention.ref import latent_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.ring_attention import ops as ra  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_bwd_work, ssd_work  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_ref, ssd_scan_bwd_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import ModelWorkload, run_calibration  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit. f32-accurate
# products are not bound by the 67 TFLOP/s of the f32 CUDA cores: split into
# three TF32 products (3×TF32, what ssd_scan.cu runs) they go through the
# tensor cores at 495 / 3 = 165 TFLOP/s, so that is the least time for f32 work.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
# The scan's training kernels run their products on the FP64 tensor cores
# (exact products of f32 operands, f64 sums) and on the f32 CUDA cores: 67
# TFLOP/s each, the data sheet's rate. Their rows give the bound at this rate
# beside the 3×TF32 bound above.
FP64_TC_FLOPS = 67e12

ARCH, BATCH, PROMPT, GEN, PAGE_TOKENS = "qwen1.5-0.5b", 4, 64, 32, 16
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
RING_F32_TOL = PAGED_TOL[torch.float32]   # bf16 is held to one bf16 ulp (bf16_ulps)
DECODE_VS_FORWARD_TOL = 0.05      # tests/test_models.py's bf16 tolerance
SSM_ARCH, SSM_PROMPT, SSM_GEN = "mamba2-780m", 512, 256
SSD_TOL = 1e-4                    # tests/test_kernels.py::test_ssd_vs_ref
# At the serving shape cs = cumsum(dt·A) runs to −O(100..500) over a chunk of
# 256, and every L_ij = exp(cs_i − cs_j) is a difference of two such sums,
# rounded in another order on each side (a sequential cumsum in the plain
# version, a tree scan in the kernel): ~|cs|·2⁻²⁴ per rounding, a few of them,
# gives L_ij a relative error up to ~1e-4, and y sums 256 × 128 such terms.
SSD_SERVING_TOL = 1e-3
SSD_SHAPES = [     # B, L, H, P, N, chunk (tests/test_kernels.py::test_ssd_vs_ref)
    (2, 128, 3, 16, 8, 32),
    (1, 64, 2, 32, 16, 64),
    (2, 96, 4, 8, 4, 16),
    (1, 256, 1, 64, 32, 64),
]
FLASH_SHAPES = [   # Sq, Skv, H, Kh, D, causal, window (tests/test_kernels.py)
    (128, 128, 4, 2, 32, True, None),
    (128, 128, 4, 4, 64, False, None),
    (256, 256, 8, 2, 32, True, 96),
    (64, 192, 2, 2, 32, True, None),
    (64, 64, 2, 1, 128, True, None),
]
# A long causal prompt (B, S, H = Kh, D): at 64 tokens every attention kernel is
# latency-bound; here the tensor-core products dominate.
LONG_PROMPT = (1, 4096, 16, 64)
# A long decode context (B, tokens, page tokens): the serving shape's 1.8 MB
# pool sits in L2; 134 MB of K/V a layer does not, as at long-context serving.
LONG_DECODE = (4, 8192, 16)
# hymba-1.5b.decode's ring (batch, position): every sequence past its window.
RING_DECODE = (64, 2047)
# deepseek-v2-lite-16b.decode's latent cache in one layer (sessions, slots:
# chat_continue_64's capacity)
LATENT_DECODE = (64, 2560)
# The latent kernel's o_lat against the f64 oracle (kernels/latent_attention/
# ref.py), max |err| / max |oracle|. At the cell's widths and lengths (B 8, 3
# seeds, on a CPU) the plain f32 products read 1.2e-6 to 1.4e-6, q_lat rounded
# once to bf16 2.5e-3 to 3.2e-3, P rounded once to bf16 1.6e-3 to 2.2e-3 (a
# lower precision than the f32 decode). LATENT_TOL allows about twenty times
# the f32 path's own rounding, for sums taken in another order, and sits some
# fifty times below either fault.
LATENT_TOL = 3e-5
# The other archs' full-width serving runs (phase serve_archs): batch, prompt,
# decode steps, and the launches each kernel must show. hymba's prompt of
# 1280 is a multiple of its 256-token scan chunk, longer than its 1024-token
# window and not a multiple of it, so the ring wraps off its slot 0.
MLA_ARCH, HYBRID_ARCH, MOE_ARCH = "deepseek-v2-lite-16b", "hymba-1.5b", "qwen2-moe-a2.7b"
SERVE_ARCHS = {   # arch: (batch, prompt, gen, {kernel: launches}); serving never
    # launches a backward
    "rdmabox-paper-100m": (4, 64, 32, {"flash_attention": 12, "flash_attention_bwd": 0,
                                       "paged_attention": 384, "ring_attention": 0,
                                       "latent_attention": 0, "ssd_scan": 0,
                                       "ssd_scan_bwd": 0, "adamw": 0}),
    "musicgen-large": (4, 64, 32, {"flash_attention": 48, "flash_attention_bwd": 0,
                                   "paged_attention": 1536, "ring_attention": 0,
                                   "latent_attention": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "adamw": 0}),
    MOE_ARCH: (4, 64, 32, {"flash_attention": 24, "flash_attention_bwd": 0,
                           "paged_attention": 768, "ring_attention": 0,
                           "latent_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                           "adamw": 0}),
    HYBRID_ARCH: (4, 1280, 32, {"flash_attention": 32, "flash_attention_bwd": 0,
                                "paged_attention": 0, "ring_attention": 1024,
                                "latent_attention": 0, "ssd_scan": 32,
                                "ssd_scan_bwd": 0, "adamw": 0}),
    MLA_ARCH: (4, 64, 32, {"flash_attention": 27, "flash_attention_bwd": 0,
                           "paged_attention": 0, "ring_attention": 0,
                           "latent_attention": 864, "ssd_scan": 0, "ssd_scan_bwd": 0,
                           "adamw": 0}),
    # the 32-35 B archs at full depth: 64.8-70.4 GB of bf16 weights beside
    # init_weights' one f32 draw of the largest tensor (serve_bytes)
    "command-r-35b": (4, 64, 32, {"flash_attention": 40, "flash_attention_bwd": 0,
                                  "paged_attention": 1280, "ring_attention": 0,
                                  "latent_attention": 0, "ssd_scan": 0,
                                  "ssd_scan_bwd": 0, "adamw": 0}),
    "qwen1.5-32b": (4, 64, 32, {"flash_attention": 64, "flash_attention_bwd": 0,
                                "paged_attention": 2048, "ring_attention": 0,
                                "latent_attention": 0, "ssd_scan": 0,
                                "ssd_scan_bwd": 0, "adamw": 0}),
    "qwen2.5-32b": (4, 64, 32, {"flash_attention": 64, "flash_attention_bwd": 0,
                                "paged_attention": 2048, "ring_attention": 0,
                                "latent_attention": 0, "ssd_scan": 0,
                                "ssd_scan_bwd": 0, "adamw": 0}),
    "llava-next-34b": (4, 64, 32, {"flash_attention": 60, "flash_attention_bwd": 0,
                                   "paged_attention": 1920, "ring_attention": 0,
                                   "latent_attention": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "adamw": 0}),
}
BIG_ARCHS = ("command-r-35b", "qwen1.5-32b", "qwen2.5-32b", "llava-next-34b")
# One 80 GB card: what a run's weights, gradients and moments may take
# (the H100 80GB HBM3 has 85.5 GB; the rest is the run's activations)
CARD_BYTES = 80e9
DENSE_DECODE = (2, 64, 32)        # dense_decode: layers, prefill, decode steps
HYBRID_DECODE = (1280, 256)       # prefill, then decode across the window's wrap
MLA_DECODE = (32, 32)             # B 1, all experts: prefill, then decode
# A long causal prompt at deepseek's D 192 (B, S, H = Kh, D), off the main path.
LONG_PROMPT_MLA = (1, 4096, 16, 192)
# Training (phases train, train_grads, train_resume): the JAX trainer's
# default arch at full width and depth, its example's batch and sequence.
# One checkpoint (and offload of the first moment) at the last step: posting
# the moment's 121.7K pages takes the host seconds, and in a checkpoint mid-run
# the steps after it wait for it (PERF.md §5).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = (
    "rdmabox-paper-100m", 8, 512, 30, 30)
# train_grads: one step each, S 512. B 4 for the SSM archs: the plain scan's
# (B, K, K, H) f32 tensors are 50 MB a chunk at B 4 (100 MB at B 8), and an f32
# copy of hymba's 1.5B parameters holds 6 GB, its gradients as much again.
# The f32 hold keeps the f32 copy and two gradient sets, 12 bytes a parameter
# (grads_bytes): at the depths of GRADS_LAYERS qwen2-moe-a2.7b 1.76 B
# parameters, 21.2 GB; deepseek-v2-lite-16b 1.59 B, 19.1 GB; musicgen-large at
# full depth 3.23 B, 38.8 GB (B 2: its 48 layers' f32 activations); llava-next-34b
# 2.03 B, 24.4 GB; qwen1.5-32b 2.61 B, 31.3 GB; qwen2.5-32b 2.53 B, 30.4 GB;
# command-r-35b 5.60 B (4.19 B of them its untied 256000-row embed and head),
# 67.2 GB, so its kernel run's gradients go to host memory before the plain
# run (GRADS_ON_HOST): 44.8 GB on the card. The MoE archs' f32 hold routes
# every token to every expert at capacity 2.0 (grads_cfg): their (E, 2T, ·)
# f32 buffers take ~15 GB a layer at B 4.
GRADS_BATCH = {"rdmabox-paper-100m": 8, ARCH: 4, SSM_ARCH: 4, HYBRID_ARCH: 4,
               MOE_ARCH: 4, MLA_ARCH: 4, "musicgen-large": 2, "llava-next-34b": 2,
               "command-r-35b": 2, "qwen1.5-32b": 2, "qwen2.5-32b": 2}
GRADS_LAYERS = {MOE_ARCH: 2, MLA_ARCH: 2, "llava-next-34b": 2, "command-r-35b": 2,
                "qwen1.5-32b": 2, "qwen2.5-32b": 2}      # the rest at full depth
GRADS_ON_HOST = ("command-r-35b",)
# train_archs: 30 steps of launch.steps.build_train_step, real top-k
# routing, no checkpoint: arch → (layers, None for full depth; batch). At
# the update a parameter holds 22 bytes (train_bytes): qwen2-moe-a2.7b 2.90 B
# parameters at 4 layers, 63.9 GB; deepseek-v2-lite-16b 2.76 B, 60.7 GB;
# musicgen-large 3.23 B at full depth, 71.1 GB.
TRAIN_ARCH_RUNS = {MOE_ARCH: (4, 4), MLA_ARCH: (4, 4), "musicgen-large": (None, 4)}
# train_ssm: mamba2-780m at full width and depth (48 layers, 48 SSM heads × 64,
# state 128, chunk 256), B 8 and S 512: two chunks, so the state's gradient
# crosses a chunk. One checkpoint, after the last step.
SSM_TRAIN_STEPS = 30
# moe_repeat: qwen2-moe-a2.7b at full width (d_model 2048, 60 experts of 1408,
# top 4, 4 shared), its depth cut from 24 layers to 2 so that a bf16 forward
# and backward fit beside the run's other state; B 4, S 512.
MOE_ARCH, MOE_LAYERS, MOE_BATCH = "qwen2-moe-a2.7b", 2, 4
# The flash backward against flash_attention_bwd_ref on the card. f32: both
# sides sum the same f32 products in other orders (on an H100 they differ by
# at most ~1e-6 on gradients up to 9 in magnitude). bf16: both
# compute in f32 from the same bf16 inputs and round each gradient once, so
# they differ by at most one bf16 step (2^-7 relative) where the two f32 sums
# straddle a rounding boundary: inside the forward's 2e-2.
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5              # the forward's LSE (|LSE| up to ~10) in f32 on both sides
# Each parameter's gradient through the kernels against the plain versions'
# on f32 copies, ‖g_kernel − g_plain‖ / ‖g_plain‖: the kernels' f32 paths run
# the same f32 arithmetic in another order, through 12-24 layers.
TRAIN_GRAD_TOL = 1e-4
TRAIN_LOSS_DROP = 0.1       # tests/test_system.py::test_training_reduces_loss
# The scan backward against ssd_scan_bwd_ref on the same inputs and states,
# max|a − b| / max(|b|, 1) per gradient: both sum cs, dcs and dA in f64 and the
# rest in f32 in other orders (~4e-7 on an H100 at mamba2's training shape).
SSD_BWD_TOL = 1e-4
# steps: (arch, the reference's shape, batch on one card, decode steps, the
# kernel the run must launch, why the shape was cut). Sequence lengths are the
# reference's; only batches are cut.
# optimized: the reference's perf knobs on the card. The MoE and MLA archs at
# train_arch_cfg's depth under each knob of OPT_KNOBS alone and under the
# port's optimize(cfg), their parameters DTensors on a 1×1 mesh, each through
# the step builders: a prefill of OPT_RUN's prompt (B, prompt, decode steps),
# its decode steps and one train step (B 4, S TRAIN_SEQ). In f32 each
# variant's logits and its train step's loss and gradient norm are held to
# the unknobbed run's (OPT_TOL, relative): the train step at
# OPT_F32_TRAIN_LAYERS, since one f32 AdamW step holds 28 bytes a parameter
# (weights, gradients, clipped gradients, old and new moments), 81 GB at 4
# layers of qwen2-moe-a2.7b's 2.9 B. On one model shard the shard-local MoE
# dispatch is the global one and the latent's partial sum is the whole sum,
# so the knobs' paths compute what base does.
OPT_KNOBS = ("moe", "mla_lat")
OPT_RUN = (4, 64, 8)
OPT_TOL = 1e-5
OPT_F32_TRAIN_LAYERS = 2
STEP_RUNS = (
    ("qwen1.5-0.5b", "prefill_32k", 1, 0, "flash_attention",
     "B 32 → 1: one 32768-token prompt's activations and 24 layers' K/V fill a "
     "share of the card; 32 would not fit beside them"),
    ("qwen1.5-0.5b", "decode_32k", 4, 8, "paged_attention",
     "B 128 → 4: a 32768-token cache is 3.2 GB a sequence (412 GB at B 128); "
     "4 sequences are a 12.9 GB pool"),
    ("mamba2-780m", "prefill_32k", 1, 0, "ssd_scan",
     "B 32 → 1, as qwen's prefill"),
    ("mamba2-780m", "long_500k", 1, 8, None,
     "B 1 as the shape; 8 decode steps on a fixed-size SSM state"),
    ("hymba-1.5b", "long_500k", 1, 8, None,
     "B 1 as the shape; 8 decode steps on the 1024-token ring and the SSM state"),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    a, b = out.float(), ref.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite output")
    if not torch.allclose(a, b, atol=tol, rtol=tol):
        raise AssertionError(f"{what}: max |err| {(a - b).abs().max().item():.3e} "
                             f"over tolerance {tol}")
    return (a - b).abs().max().item()


def device_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events (no host gaps between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def random_table(rng: np.random.Generator, B: int, Pmax: int, P: int, T: int,
                 contiguous: bool):
    """The reference suite's page tables (trailing -1 padding) and lengths."""
    table = -np.ones((B, Pmax), np.int32)
    for b in range(B):
        n = rng.integers(1, Pmax + 1)
        if contiguous:
            start = rng.integers(0, P - n)
            table[b, :n] = np.arange(start, start + n)
        else:
            table[b, :n] = rng.choice(P, size=n, replace=False)
    lengths = ((table >= 0).sum(1) * T - rng.integers(0, T, B)).astype(np.int32)
    return table, torch.from_numpy(lengths)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "name": torch.cuda.get_device_name(0)})
    return smi.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {}
    for name, so in libs.items():
        log = so.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = {
            "used": [ln.split(":", 1)[1].strip() for ln in lines if "Used" in ln],
            "spill_free": all("0 bytes spill stores, 0 bytes spill loads" in ln
                              for ln in lines if "spill" in ln)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": ptxas})


def phase_compare(dev: torch.device) -> dict:
    """Each kernel against its plain version; returns the serving-shape errors."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    report = {"flash": [], "paged": []}
    main_err = {}
    cfg = get_config(ARCH)
    serving = (BATCH, PROMPT, PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
               True, None)
    B, S, H, D = LONG_PROMPT
    long_prompt = (B, S, S, H, H, D, True, None)
    B, S, H, D = LONG_PROMPT_MLA
    long_mla = (B, S, S, H, H, D, True, None)
    mla, hybrid = flash_mla_shape(), flash_hybrid_shape()
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[dtype]
        shapes = [(2, *s) for s in FLASH_SHAPES] + (
            [long_prompt, long_mla, hybrid] if dtype == torch.bfloat16 else []) + [
            mla, serving]
        for B, Sq, Skv, H, Kh, D, causal, window in shapes:
            q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
            out = fa.flash_attention_op(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, attention_ref(q, k, v, causal=causal, window=window),
                          tol, f"flash {dtype} {(B, Sq, Skv, H, Kh, D, causal, window)}")
            report["flash"].append({"shape": [B, Sq, Skv, H, Kh, D], "causal": causal,
                                    "window": window, "dtype": str(dtype),
                                    "max_abs_err": err})
            for name, shape in (("flash_long", long_prompt), ("flash_long_mla", long_mla),
                                ("flash_mla", mla), ("flash_hybrid", hybrid)):
                if (B, Sq, Skv, H, Kh, D, causal, window) == shape:
                    main_err[(name, dtype)] = err
            del q, k, v, out
        main_err[("flash", dtype)] = err          # the serving shape comes last
    report["flash_bwd"], main_err[("flash_train", torch.bfloat16)] = \
        compare_flash_bwd(dev, gen)
    for dtype in (torch.float32, torch.bfloat16):
        tol = PAGED_TOL[dtype]
        B, H, Kh, D, T, P, Pmax = 3, 8, 4, 32, 8, 40, 6
        for R in (1, 2, 4):
            for contig in (True, False):
                q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
                kv = torch.randn(P, T, 2, Kh, D, generator=gen, device=dev).to(dtype)
                table, lengths = random_table(rng, B, Pmax, P, T, contig)
                lengths = lengths.to(dev)
                out = pa.paged_attention(q, kv, table, lengths, pages_per_block=R)
                torch.cuda.synchronize()
                plan = pa.upload_plan(table, R, dev)
                what = f"paged {dtype} R={R} contiguous={contig}"
                err = max_err(out, pa.paged_attention_plain(
                    q, kv, *plan, lengths, pages_per_block=R), tol, what)
                max_err(out, paged_attention_ref(q, kv, torch.from_numpy(table).to(dev),
                                                 lengths), tol, what + " vs oracle")
                report["paged"].append({"R": R, "contiguous": contig,
                                        "dtype": str(dtype), "max_abs_err": err})
        for case in paged_edge_cases(dev, gen, dtype):
            report["paged"].append({**check_paged_case(case, tol), "dtype": str(dtype)})
        for name, arch in (("paged_moe", MOE_ARCH), ("paged_gqa", "qwen2.5-32b"),
                           ("paged", ARCH)):
            if name != "paged" and dtype != torch.bfloat16:
                continue
            q, kv, lengths, plan = paged_inputs(dev, gen, dtype, arch)
            out = pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plan)
            torch.cuda.synchronize()
            main_err[(name, dtype)] = max_err(
                out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=4),
                tol, f"paged {dtype} serving shape, {arch}")
    q, kv, lengths, plans = paged_long_inputs(dev, gen)
    main_err[("paged_long", torch.bfloat16)] = err = max_err(
        pa.paged_attention(q, kv, None, lengths, pages_per_block=4, plan=plans[4][:2],
                           live_blocks=plans[4][2]),
        pa.paged_attention_plain(q, kv, *plans[4][:2], lengths, pages_per_block=4),
        PAGED_TOL[torch.bfloat16], "paged long context")
    report["paged"].append({"case": "long context", "dtype": "torch.bfloat16",
                            "max_abs_err": err})
    del q, kv, lengths, plans
    report["ring"] = [check_ring_case(case) for case in ring_edge_cases(dev, gen)]
    q, k, v, valid = ring_decode_inputs(dev, gen)
    out = ra.ring_attention(q, k, v, valid, q.shape[2] ** -0.5)
    plain = ra.ring_attention_plain(q, k, v, valid, q.shape[2] ** -0.5)
    ulps = bf16_ulps(out, plain)
    if not ulps <= 1:
        raise AssertionError(f"ring serving shape: {ulps:.2f} bf16 ulps off the plain version")
    main_err[("ring", torch.bfloat16)] = (out.float() - plain.float()).abs().max().item()
    report["ring"].append({"case": f"serving: {HYBRID_ARCH} decode", "ulps": ulps})
    q, k, v, valid = ring_decode_inputs(dev, gen, torch.float32)
    err = max_err(ra.ring_attention(q, k, v, valid, q.shape[2] ** -0.5),
                  ra.ring_attention_plain(q, k, v, valid, q.shape[2] ** -0.5), RING_F32_TOL,
                  "ring f32 serving shape")
    report["ring"].append({"case": f"serving: {HYBRID_ARCH} decode, f32", "max_abs_err": err})
    del q, k, v, valid, out, plain
    torch.cuda.empty_cache()
    report["ssd"], main_err[("ssd", torch.float32)], main_err[("ssd_hybrid", torch.float32)] \
        = compare_ssd(dev, gen)
    report["ssd_bwd"] = compare_ssd_bwd(dev, gen)
    emit({"phase": "kernels_vs_plain", **report,
          "serving_shape_max_abs_err": {f"{k}/{d}": e for (k, d), e in main_err.items()}})
    return main_err


def ssd_inputs(dev, gen, B, L, H, P, N, *, model_like=False):
    """tests/test_kernels.py's SSD distributions; ``model_like`` draws dt and
    A as mamba2's mixer makes them (softplus of a projection, −exp(A_log)),
    so exp(cs) underflows to 0 within a chunk of 256."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    x, Bm, Cm = randn(B, L, H, P) * 0.5, randn(B, L, N) * 0.5, randn(B, L, N) * 0.5
    if model_like:
        dt = torch.nn.functional.softplus(randn(B, L, H))
        A = -torch.exp(rand(H) * 1.5)
    else:
        dt = 0.01 + 0.19 * rand(B, L, H)
        A = -(0.5 + 1.5 * rand(H))
    return x, Bm, Cm, dt, A


def ssd_serving_shape(arch: str = SSM_ARCH, prompt: int = SSM_PROMPT):
    cfg = get_config(arch)
    return (BATCH, prompt, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)


def ssd_hybrid_shape():
    """hymba's prefill scan: (4, 1280, 50, 64), N 16, chunk 256."""
    return ssd_serving_shape(HYBRID_ARCH, SERVE_ARCHS[HYBRID_ARCH][1])


def flash_mla_shape():
    """deepseek's prefill: (B, Sq, Skv, H, Kh, D, causal, window), D = qk_nope + qk_rope."""
    cfg = get_config(MLA_ARCH)
    B, S = SERVE_ARCHS[MLA_ARCH][:2]
    D = cfg.qk_nope_dim + cfg.qk_rope_dim
    return (B, S, S, cfg.num_heads, cfg.num_heads, D, True, None)


def flash_hybrid_shape():
    """hymba's prefill: GQA 25/5, D 64, a 1024-token window over 1280 tokens."""
    cfg = get_config(HYBRID_ARCH)
    B, S = SERVE_ARCHS[HYBRID_ARCH][:2]
    return (B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True, cfg.window)


def compare_ssd(dev, gen) -> tuple[list, float, float]:
    """ssd_scan against ssd_chunked and the sequential ssd_ref, and h_final
    against ssd_chunked's; returns (report, max |err| of y at mamba2's serving
    shape, at hymba's)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain side in true f32
    report = []

    def check(what, args, chunk, tol, oracle=True):
        y, h = ssd.ssd_scan_op(*args, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        y_plain, h_plain = ssd_chunked(*args, chunk=chunk)
        err = max_err(y, y_plain, tol, f"ssd {what}")
        row = {"case": what, "shape": list(args[0].shape), "N": args[1].shape[-1],
               "chunk": chunk, "tol": tol, "max_abs_err": err,
               "h_final_max_abs_err": max_err(h, h_plain, tol, f"ssd {what} h_final")}
        if oracle:
            row["vs_ssd_ref_max_abs_err"] = max_err(y, ssd_ref(*args), tol,
                                                    f"ssd {what} vs oracle")
        report.append(row)
        return y, err

    for B, L, H, P, N, chunk in SSD_SHAPES:
        check("reference shape", ssd_inputs(dev, gen, B, L, H, P, N), chunk, SSD_TOL)
    # state continuity: splitting L into more chunks changes nothing
    args = ssd_inputs(dev, gen, 1, 128, 2, 8, 4)
    args = (*args[:4], -torch.ones(2, device=dev))
    y16, _ = check("continuity chunk 16", args, 16, SSD_TOL)
    y128, _ = check("continuity chunk 128", args, 128, SSD_TOL)
    report.append({"case": "continuity 16 vs 128",
                   "max_abs_err": max_err(y16, y128, SSD_TOL, "ssd continuity")})
    B, L, H, P, N, K = ssd_serving_shape()
    check("serving shape, test distributions", ssd_inputs(dev, gen, B, L, H, P, N), K,
          SSD_SERVING_TOL)
    _, err = check("serving shape, model-like dt and A",
                   ssd_inputs(dev, gen, B, L, H, P, N, model_like=True), K,
                   SSD_SERVING_TOL, oracle=False)
    B, L, H, P, N, K = ssd_hybrid_shape()
    _, err_hybrid = check("hymba prefill, model-like dt and A",
                          ssd_inputs(dev, gen, B, L, H, P, N, model_like=True), K, SSD_TOL,
                          oracle=False)
    return report, err, err_hybrid


def ssd_bwd_shapes() -> list:
    """(case, B, L, H, P, N, chunk) of the scan backward's checks: the reference
    suite's scan shapes, ragged tiles, and the training shapes of mamba2-780m
    (train_ssm's B 8) and hymba-1.5b (train_grads' B 4), S 512."""
    m, h = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    return ([("reference shape", *s) for s in SSD_SHAPES] + [
        ("ragged K, N, P", 1, 21, 2, 5, 3, 7),
        ("two row blocks, ragged", 2, 200, 2, 33, 70, 100),
        (f"train: {SSM_ARCH}", TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim,
         m.ssm_state, m.ssm_chunk),
        (f"train_grads: {HYBRID_ARCH}", GRADS_BATCH[HYBRID_ARCH], TRAIN_SEQ, h.ssm_heads,
         h.ssm_head_dim, h.ssm_state, h.ssm_chunk)])


def ssd_bwd_rel_errs(grads, plain, what: str) -> dict:
    """max|a − b| / max(|b|, 1) of each of the five gradients, held to SSD_BWD_TOL."""
    out = {}
    for name, g, p in zip(("dx", "dB", "dC", "ddt", "dA"), grads, plain):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} {name}: non-finite gradient")
        err = ((g - p).abs().max() / p.abs().max().clamp(min=1.0)).item()
        if not err <= SSD_BWD_TOL:
            raise AssertionError(f"{what} {name}: relative error {err:.3e} over {SSD_BWD_TOL}")
        out[name] = err
    return out


def compare_ssd_bwd(dev, gen) -> list:
    """The scan's training forward and its backward against their plain
    versions: y, h_final and the chunk-entry states against ``ssd_chunked``'s
    with cs in f64 (as the training instance sums it) at SSD_TOL, and the
    backward from those states (with and without h_final's cotangent) held
    to SSD_BWD_TOL, run twice and held to equal bits."""
    report = []
    for case, B, L, H, P, N, K in ssd_bwd_shapes():
        x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=K == 256)
        dy = torch.randn(B, L, H, P, generator=gen, device=dev)
        dh = torch.randn(B, H, N, P, generator=gen, device=dev)
        what = f"ssd bwd {case} {(B, L, H, P, N, K)}"
        y, h, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
        torch.cuda.synchronize()
        y_plain, h_plain, states_plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=K,
                                                     return_states=True, cs64=True)
        row = {"case": case, "shape": [B, L, H, P, N, K], "tol": SSD_BWD_TOL,
               "fwd_tol": SSD_TOL,
               "y_max_abs_err": max_err(y, y_plain, SSD_TOL, what + " y"),
               "h_final_max_abs_err": max_err(h, h_plain, SSD_TOL, what + " h_final"),
               "states_max_abs_err": max_err(states, states_plain, SSD_TOL,
                                             what + " states"),
               "bitwise_repeatable": True}
        for name, cot in (("dh_final", dh), ("no_dh_final", None)):
            grads = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            again = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, cot, K)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"{what} {name}: two runs gave different bits")
            plain = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, cot, chunk=K)
            row[f"rel_err_{name}"] = ssd_bwd_rel_errs(grads, plain, f"{what} {name}")
            del grads, again, plain
        report.append(row)
        del x, Bm, Cm, dt, A, dy, dh, y, h, states, y_plain, h_plain, states_plain
    torch.cuda.empty_cache()
    return report


def paged_inputs(dev, gen, dtype, arch: str = ARCH):
    """The serving path's decode inputs at its last step: 4 sequences of 96
    tokens in 6 contiguous pages of 16, one layer of a 24 + 3 page pool, at
    ``arch``'s heads."""
    cfg = get_config(arch)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_seq = -(-(PROMPT + GEN) // PAGE_TOKENS)
    P = BATCH * per_seq + 4 - 1
    table = torch.arange(BATCH * per_seq, dtype=torch.int32).view(BATCH, per_seq).numpy()
    q = torch.randn(BATCH, H, D, generator=gen, device=dev).to(dtype)
    kv = torch.randn(P, PAGE_TOKENS, 2, Kh, D, generator=gen, device=dev).to(dtype)
    lengths = torch.full((BATCH,), PROMPT + GEN, dtype=torch.int32, device=dev)
    return q, kv, lengths, pa.upload_plan(table, 4, dev)


def paged_long_inputs(dev, gen):
    """A long context off the serving path: qwen1.5-0.5b's heads, bf16, B 4,
    each sequence one contiguous run of 8192 tokens in pages of 16, a pool of
    2048 + 3 pages (134 MB of K/V, beyond the 50 MB L2). Returns q, pool,
    lengths and the plan at R = 4 and R = 1 as (block_start, block_valid,
    live descriptors)."""
    cfg = get_config(ARCH)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, T = LONG_DECODE
    per_seq = S // T
    table = np.arange(B * per_seq, dtype=np.int32).reshape(B, per_seq)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    kv = torch.randn(B * per_seq + 4 - 1, T, 2, Kh, D, generator=gen, device=dev).bfloat16()
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    plans = {}
    for R in (4, 1):
        starts, valid = pa.plan_blocks(table, R)
        dev_plan = torch.from_numpy(np.stack([starts, valid])).to(dev)
        plans[R] = (dev_plan[0], dev_plan[1],
                    pa.count_live_blocks(valid, np.full(B, S), T))
    return q, kv, lengths, plans


def paged_edge_cases(dev, gen, dtype):
    """The paged kernel's edge cases: every G and D, lengths that end mid-page,
    mid-stage and on a split boundary, trailing empty descriptors, a
    fragmented R = 1 table, a pool view at layer 2 of 3, 2 and 4 KV heads a
    CTA, forced splits with splits that hold no live token, and 4096 tokens
    of context with S > 1. Yields dicts of the wrapper's arguments plus
    ``what``, ``splits`` and ``heads`` (None: the wrapper's choice)."""
    rng = np.random.default_rng(5)

    def case(what, B, H, Kh, D, T, R, per_seq, lengths, *, contiguous=True,
             layers=1, splits=None, heads=None):
        P = B * per_seq + 8
        table = -np.ones((B, per_seq + 2), np.int32)   # two trailing empty columns
        pages = (np.arange(B * per_seq) if contiguous else rng.permutation(P)[:B * per_seq])
        table[:, :per_seq] = pages.reshape(B, per_seq)
        pool = torch.randn(layers, P + R - 1, T, 2, Kh, D, generator=gen,
                           device=dev).to(dtype)
        return {"what": what, "q": torch.randn(B, H, D, generator=gen, device=dev).to(dtype),
                "kv": pool[layers - 1], "table": table, "R": R, "splits": splits,
                "heads": heads,
                "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev)}

    for G in (1, 2, 8):
        for D in (32, 64, 128):
            # lengths: full, mid-page, one token
            yield case(f"G {G} D {D}", 3, 2 * G, 2, D, 16, 4, 9, [144, 87, 1])
    # qwen2.5-32b's and llava-next-34b's groups: the G 8 instance, G rows live
    for G in (5, 7):
        yield case(f"G {G} D 128", 3, 2 * G, 2, 128, 16, 4, 9, [144, 87, 1])
    # a stage is 16 tokens (f32, D 128) or 32 (bf16): 88 ends mid-stage either way
    yield case("mid-stage", 2, 4, 4, 128, 16, 4, 8, [88, 128])
    # R 1: 12 live descriptors in 4 forced splits of 3, so splits start at
    # 48, 96 and 144 tokens; every length ends on a split boundary
    yield case("split boundary", 3, 4, 2, 64, 16, 1, 16, [48, 96, 192], splits=4)
    yield case("fragmented R 1", 3, 8, 4, 32, 8, 1, 6, [48, 41, 3], contiguous=False)
    yield case("pool layer 2 of 3", 2, 16, 16, 64, 16, 4, 6, [96, 70], layers=3)
    # several KV heads a CTA: one box holds their rows side by side
    yield case("4 heads a CTA, 3 splits", 2, 16, 16, 64, 16, 4, 12, [192, 101], layers=2,
               splits=3, heads=4)
    yield case("2 heads a CTA, G 8 D 128", 2, 16, 2, 128, 16, 2, 9, [144, 33], heads=2)
    # one long and one short sequence: the short one's later splits are empty
    yield case("forced splits, empty splits", 2, 8, 2, 64, 16, 2, 16, [256, 20], splits=8)
    yield case("4096 tokens, S > 1", 2, 8, 4, 64, 16, 4, 256, [4096, 3001])


def check_paged_case(case: dict, tol: float) -> dict:
    """One edge case through the kernel, held to the plain version and the oracle."""
    q, kv, table, lengths, R = (case[k] for k in ("q", "kv", "table", "lengths", "R"))
    B, H, _ = q.shape
    starts, valid = pa.plan_blocks(table, R)
    live = pa.count_live_blocks(valid, lengths.cpu().numpy(), kv.shape[1])
    run_bytes = R * kv.shape[1] * 2 * kv.shape[4] * kv.element_size()
    heads, splits = pa.launch_shape(B, kv.shape[3], live, pa.sm_count(q.device), run_bytes)
    heads, splits = case["heads"] or heads, case["splits"] or splits
    out = pa.paged_attention(q, kv, table, lengths, pages_per_block=R, splits=splits,
                             heads_per_cta=heads, live_blocks=live)
    torch.cuda.synchronize()
    plan = pa.upload_plan(table, R, q.device)
    what = f"paged {q.dtype} {case['what']}"
    err = max_err(out, pa.paged_attention_plain(q, kv, *plan, lengths, pages_per_block=R),
                  tol, what)
    max_err(out, paged_attention_ref(q, kv, torch.from_numpy(table).to(q.device), lengths),
            tol, what + " vs oracle")
    return {"case": case["what"], "H": H, "Kh": kv.shape[3], "D": kv.shape[4], "R": R,
            "heads_per_cta": heads, "splits": splits, "live_blocks": live, "max_abs_err": err}


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out − ref| in bf16 ulps of the larger of the two: 1.0 is
    one rounding step apart (a bf16 value has 8 significant bits). A value
    that cancels to under 1/256 of ref's largest is measured in the ulps of
    that level: it carries the absolute error of the f32 sums that made it
    (about 1e-6 of the output's scale), which no order of summation avoids."""
    a, b = out.float(), ref.float()
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite output")
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), b.abs().max() / 256)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return ((a - b).abs() / torch.where(mag > 0, ulp, 1.0)).max().item()


def ring_inputs(dev, gen, B: int, H: int, Kh: int, D: int, length: int, cur, *,
                layers: int = 1, dtype=torch.bfloat16):
    """q, a ring of K and V in ``dtype`` (layer ``layers − 1`` of that many) and the
    ring cache's mask for positions ``cur`` (``SlotCache.plan_step``'s rule:
    slot s counts while its age (cur % length − s) mod length is below
    min(cur + 1, length))."""
    cur = np.asarray(cur, np.int64)
    age = (cur[:, None] % length - np.arange(length)[None, :]) % length
    valid = torch.from_numpy(age < np.minimum(cur + 1, length)[:, None]).to(dev)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(layers, B, length, Kh, D, generator=gen, device=dev).to(dtype)[-1]
            for _ in range(2))
    return q, k, v, valid


def ring_decode_inputs(dev, gen, dtype=torch.bfloat16, B: int = RING_DECODE[0]):
    """``hymba-1.5b.decode``'s ring in one layer: 64 (or ``B``) sequences past
    their 1024-token window (every slot valid), hymba's heads."""
    cfg = get_config(HYBRID_ARCH)
    return ring_inputs(dev, gen, B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.window, np.full(B, RING_DECODE[1]), dtype=dtype)


def ring_edge_cases(dev, gen):
    """The ring kernel's edge cases, in bf16 and f32: each instance's (D, G) on
    a wrapped ring whose length is no multiple of a stage, one valid slot, B 1
    at hymba's heads, forced splits of which some hold no valid slot, valid
    slots straddling the ring's end, a ring view at layer 1 of 2. Yields dicts
    of the wrapper's arguments plus ``what`` and ``splits`` (None: the
    wrapper's choice)."""
    def case(what, B, H, Kh, D, length, cur, *, splits=None, valid=None, **kw):
        q, k, v, mask = ring_inputs(dev, gen, B, H, Kh, D, length, cur, dtype=dtype, **kw)
        if valid is not None:
            mask = valid.to(dev)
        return {"what": f"{what}, {str(dtype)[6:]}", "q": q, "k": k, "v": v, "valid": mask,
                "splits": splits}

    for dtype in (torch.bfloat16, torch.float32):
        for D, G in ra.INSTANCES:
            yield case(f"G {G} D {D}", 2, 2 * G, 2, D, 200, [150, 450])
        yield case("one valid slot", 4, 10, 2, 64, 256, [0, 0, 0, 0])
        yield case("B 1, hymba's heads", 1, 25, 5, 64, 1024, [1500])
        yield case("forced splits, empty splits", 3, 10, 2, 64, 1024, [700, 5, 100], splits=8)
        straddle = torch.zeros(2, 300, dtype=torch.bool)
        straddle[:, 280:] = straddle[:, :45] = True
        yield case("valid slots across the end", 2, 10, 2, 64, 300, [0, 0], valid=straddle,
                   splits=2)
        yield case("ring layer 1 of 2", 2, 16, 2, 128, 96, [95, 40], layers=2)


def check_ring_case(case: dict) -> dict:
    """One edge case through the kernel twice: equal bits, and within a bf16
    ulp of the plain version (f32: within RING_F32_TOL)."""
    q, k, v, valid = (case[n] for n in ("q", "k", "v", "valid"))
    B, H, D = q.shape
    length, Kh = k.shape[1], k.shape[2]
    S = case["splits"] or ra.split_count(B * Kh, length, ra.sm_count(q.device))
    out = ra.ring_attention(q, k, v, valid, D ** -0.5, splits=S)
    again = ra.ring_attention(q, k, v, valid, D ** -0.5, splits=S)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"ring {case['what']}: two runs differ")
    plain = ra.ring_attention_plain(q, k, v, valid, D ** -0.5)
    row = {"case": case["what"], "B": B, "H": H, "Kh": Kh, "D": D, "slots": length,
           "q": str(q.dtype), "splits": S}
    if q.dtype == torch.float32:
        return {**row, "max_abs_err": max_err(out, plain, RING_F32_TOL, f"ring {case['what']}")}
    ulps = bf16_ulps(out, plain)
    if not ulps <= 1:
        raise AssertionError(f"ring {case['what']}: {ulps:.2f} bf16 ulps off the plain version")
    return {**row, "ulps": ulps}


@torch.no_grad()
def phase_serve(dev: torch.device) -> dict:
    cfg = get_config(ARCH)
    args = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--page-tokens", str(PAGE_TOKENS)]
    emit({"phase": "serve_warmup", "note": "2 decode steps: cuBLAS and allocator warm-up"})
    serve.main(args + ["--gen", "2"])             # its model is dropped here
    torch.cuda.empty_cache()
    reset_launches()
    res = serve.main(args + ["--gen", str(GEN)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * GEN, "ring_attention": 0, "latent_attention": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adamw": 0}
    if launches != want:
        raise AssertionError(f"serving path launches {launches}, want {want}")
    logits = res.decode_logits.float()
    if tuple(logits.shape) != (BATCH, GEN, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"decode logits: shape {tuple(logits.shape)}, or not finite")
    full = res.model(torch.cat([res.prompts, res.fed], dim=1))[:, PROMPT:].float()
    rel = ((full - logits).abs().max() / full.abs().max().clamp(min=1.0)).item()
    if not rel < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"decode vs forward: relative error {rel:.4f}")
    emit({"phase": "serve", "arch": ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": sum(p.numel() for p in res.model.parameters()),
          "batch": BATCH, "prompt": PROMPT, "gen": GEN, "prefill_s": res.prefill_s,
          "decode_s": res.decode_s, "decode_tok_s": GEN * BATCH / res.decode_s,
          "launches": launches, "decode_vs_forward_rel_err": rel,
          "page_table": res.cache.page_table.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"launches": launches, "model": res.model, "prompts": res.prompts}


# kernel → (wrapper module, its counter): each adds one where it launches
LAUNCH_COUNTERS = {"flash_attention": (fa, "launches"),
                   "flash_attention_bwd": (fa, "bwd_launches"),
                   "paged_attention": (pa, "launches"), "ring_attention": (ra, "launches"),
                   "latent_attention": (la, "launches"),
                   "ssd_scan": (ssd, "launches"),
                   "ssd_scan_bwd": (ssd, "bwd_launches"), "adamw": (aw, "launches")}


def rel_err(full: torch.Tensor, dec: torch.Tensor) -> float:
    """max|forward − decode| / max(|forward|, 1), tests/test_models.py's measure."""
    full, dec = full.float(), dec.float()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("non-finite logits")
    return ((full - dec).abs().max() / full.abs().max().clamp(min=1.0)).item()


def largest_tensor(cfg) -> int:
    """Elements of ``cfg``'s largest parameter, from a model on the meta device."""
    from repro_torch.models.transformer import Transformer
    return max(p.numel() for p in Transformer(cfg, device="meta").parameters())


def serve_bytes(cfg) -> int:
    """Device bytes of serving ``cfg`` before its first token: bf16 weights (2
    bytes a parameter of ``param_count()``) and init_weights' f32 draw of the
    largest tensor (the KV pool of a few hundred tokens is small beside them)."""
    return 2 * cfg.param_count() + 4 * largest_tensor(cfg)


def grads_cfg(arch: str, routed: bool = False):
    """train_grads' config of ``arch``: depth cut to GRADS_LAYERS; with
    ``routed`` (the f32 hold) a MoE arch routes every token to every expert
    at capacity 2.0, as tests/test_models.py pins it (top-k routing is
    discontinuous: an f32 difference of 1e-6 in a router logit can move a
    token to another expert)."""
    from repro_torch.configs import replace
    cfg = get_config(arch)
    if arch in GRADS_LAYERS:
        cfg = replace(cfg, num_layers=GRADS_LAYERS[arch])
    if routed and cfg.uses_moe:
        cfg = replace(cfg, top_k=cfg.num_experts, capacity_factor=2.0)
    return cfg


def grads_bytes(arch: str) -> int:
    """Device bytes of train_grads' f32 hold: the f32 copy and the plain run's
    gradients, and the kernel run's unless they go to host memory."""
    return (8 if arch in GRADS_ON_HOST else 12) * grads_cfg(arch).param_count()


def train_arch_cfg(arch: str):
    """train_archs' config of ``arch``: depth cut to TRAIN_ARCH_RUNS' layers."""
    from repro_torch.configs import replace
    layers = TRAIN_ARCH_RUNS[arch][0]
    cfg = get_config(arch)
    return cfg if layers is None else replace(cfg, num_layers=layers)


def train_bytes(arch: str) -> int:
    """Device bytes of train_archs' state at the AdamW update: bf16 weights,
    gradients and their clipped copies (6 bytes a parameter), and the old and
    the new f32 moments side by side (16: ``adamw.update`` returns new ones)."""
    return 22 * train_arch_cfg(arch).param_count()


@torch.no_grad()
def phase_serve_archs(smi: str) -> dict:
    """``serve.main`` at full width and depth for every arch besides
    ``serve``'s and ``serve_ssm``'s, each with its launches reset just before
    and read just after, its model freed before the next; the peak device
    memory beside serve_bytes' reckoning. Returns arch → launches."""
    from repro_torch.configs import get_config as cfg_of
    out = {}
    for arch, (B, prompt, gen, want) in SERVE_ARCHS.items():
        cfg = cfg_of(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(prompt),
                          "--gen", str(gen)])
        torch.cuda.synchronize()
        launches = read_launches()
        seconds = time.perf_counter() - t0
        if launches != want:
            raise AssertionError(f"{arch}: serving path launches {launches}, want {want}")
        logits = res.decode_logits.float()
        if tuple(logits.shape) != (B, gen, cfg.padded_vocab) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{arch}: decode logits {tuple(logits.shape)} or not finite")
        out[arch] = launches
        peak_gb, reckoned_gb = torch.cuda.max_memory_allocated() / 1e9, serve_bytes(cfg) / 1e9
        print(f"{arch}: {cfg.num_layers} layers, prefill {res.prefill_s:.6f} s, decode "
              f"{gen * B / res.decode_s:,.1f} tok/s, launches {launches}, peak "
              f"{peak_gb:.2f} GB (reckoned {reckoned_gb:.2f}) [{smi}]")
        emit({"phase": "serve_archs", "arch": arch, "family": cfg.family,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "params": sum(p.numel() for p in res.model.parameters()),
              "param_count": cfg.param_count(), "cache": type(res.cache).__name__,
              "batch": B, "prompt": prompt, "gen": gen, "embeddings": bool(cfg.frontend),
              "prefill_s": res.prefill_s, "decode_s": res.decode_s,
              "decode_tok_s": gen * B / res.decode_s, "launches": launches,
              "peak_mem_gb": peak_gb, "reckoned_gb": reckoned_gb, "seconds": seconds,
              "card": smi})
        del res, logits
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_kernels():
    """Within the block, flash attention and the scan (each forward and
    backward), paged, ring and latent attention run their plain versions
    (those the CPU path runs) on the card's tensors, and launch nothing."""
    saved = (fa._launch, fa._launch_bwd, ssd._launch, ssd._launch_bwd, pa._launch, ra._launch,
             la._launch)
    fa._launch = lambda q, k, v, causal, window, with_lse=False: flash_attention_online(
        q, k, v, causal=causal, window=window, q_offset=k.shape[1] - q.shape[1],
        return_lse=with_lse)
    fa._launch_bwd = lambda q, k, v, o, lse, do, causal, window: flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window, q_offset=k.shape[1] - q.shape[1])
    ssd._launch = lambda x, Bm, Cm, dt, A, chunk, return_state, with_states=False: ssd_chunked(
        x, Bm, Cm, dt, A, chunk=chunk, return_states=with_states, cs64=with_states)
    ssd._launch_bwd = lambda x, Bm, Cm, dt, A, states, dy, dh, chunk: ssd_scan_bwd_ref(
        x, Bm, Cm, dt, A, states, dy, dh, chunk=chunk)
    pa._launch = lambda q, kv, starts, valid, lengths, R, *launch_shape: (
        pa.paged_attention_plain(q, kv, starts, valid, lengths, pages_per_block=R))
    ra._launch = lambda q, k, v, valid, scale, splits: ra.ring_attention_plain(
        q, k, v, valid, scale)
    la._launch = lambda q_lat, q_pe, c_kv, k_pe, valid, scale, splits: (
        la.latent_attention_plain(q_lat, q_pe, c_kv, k_pe, valid, scale))
    try:
        yield
    finally:
        (fa._launch, fa._launch_bwd, ssd._launch, ssd._launch_bwd, pa._launch, ra._launch,
         la._launch) = saved


# (run, dtype, plain): the serving path in bf16, the same with its prefill
# kernels swapped for their plain versions, and an f32 copy through the kernels
DECODE_RUNS = (("bf16", "bf16", False), ("bf16_plain", "bf16", True), ("f32", "f32", False))


@torch.no_grad()
def decode_vs_forward(cfg, prompt: int, steps: int, seed: int) -> dict:
    """B 1 at full width from seed-0 weights: prefill ``prompt`` tokens, decode
    ``steps`` more one at a time, and run one forward over all of them, for
    each of DECODE_RUNS. Returns each run's decode-vs-forward error and
    launches, each bf16 run's forward against the f32 copy's forward (what
    bf16 alone moves), and the peak device memory in GB."""
    from repro_torch.models import init_transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    if cfg.frontend:     # a stubbed frontend's N(0, 1) embeddings, as serve draws them
        toks = torch.from_numpy(rng.normal(size=(1, prompt + steps, cfg.d_model)).astype(
            np.float32)).cuda().bfloat16()
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt + steps))).cuda()
    model = init_transformer(cfg, seed=0, device="cuda")
    dvf, fwd, launched = {}, {}, {}
    for run, dtype, plain in DECODE_RUNS:
        if dtype == "f32":
            model.float()
        reset_launches()
        with plain_kernels() if plain else contextlib.nullcontext():
            cache = model.init_cache(1, prompt + steps)
            model.prefill(toks[:, :prompt], cache)
            dec = torch.stack([model.decode_step(cache, toks[:, prompt + i],
                                                 np.array([prompt + i]))
                               for i in range(steps)], dim=1)
            fwd[run] = model(toks)[:, prompt:].float()
            launched[run] = read_launches()
        if (launched[run]["flash_attention"] == 0) != plain:
            raise AssertionError(f"{run}: flash launches {launched[run]}")
        ring = cfg.num_layers * steps if cfg.window and not plain else 0
        if launched[run]["ring_attention"] != ring:   # every window layer's decode, f32 too
            raise AssertionError(f"{run}: ring launches {launched[run]}, not {ring}")
        latent = cfg.num_layers * steps if cfg.attention == "mla" and not plain else 0
        if launched[run]["latent_attention"] != latent:   # every MLA layer's decode, f32 too
            raise AssertionError(f"{run}: latent launches {launched[run]}, not {latent}")
        dvf[run] = rel_err(fwd[run], dec)
        del cache, dec
    out = {"decode_vs_forward": dvf, "launches": launched,
           "forward_vs_f32": {run: rel_err(fwd["f32"], fwd[run])
                              for run, dtype, _ in DECODE_RUNS if dtype == "bf16"},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, fwd
    torch.cuda.empty_cache()
    return out


def hold_decode_vs_forward(phase: str, arch: str, res: dict, **facts) -> None:
    """Print ``decode_vs_forward``'s result, hold the f32 copy's error to
    DECODE_VS_FORWARD_TOL (random bf16 weights amplify rounding past it, as
    mamba2's do), emit."""
    dvf = res["decode_vs_forward"]
    print(f"{arch} decode vs forward: "
          + ", ".join(f"{k} {v:.6f}" for k, v in dvf.items())
          + f" (bound {DECODE_VS_FORWARD_TOL}, held in f32); bf16 forward vs f32 forward: "
          + ", ".join(f"{k} {v:.6f}" for k, v in res["forward_vs_f32"].items()))
    if not dvf["f32"] < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"{arch} decode vs forward in f32: {dvf['f32']:.4f}")
    emit({"phase": phase, "arch": arch, **facts, **res, "held": "f32"})


def phase_hybrid_decode() -> None:
    """hymba across its window's wrap: prefill of 1280 tokens through flash
    (window 1024) and the scan, 256 decode steps over the ring and the SSM
    state, one forward over the 1536 tokens."""
    cfg = get_config(HYBRID_ARCH)
    prompt, steps = HYBRID_DECODE
    res = decode_vs_forward(cfg, prompt, steps, seed=3)
    hold_decode_vs_forward("hybrid_decode", HYBRID_ARCH, res, prefill=prompt,
                           decode=steps, window=cfg.window,
                           ring_slot_of_first_decode=prompt % cfg.window)


def phase_dense_decode() -> None:
    """The four 32-35 B archs at full width, depth cut to 2 layers: prefill of
    64 tokens through flash, 32 decode steps through paged attention (GQA
    groups 8, 1, 5 and 7 at D 128), one forward over the 96 (llava-next-34b
    on embeddings); held in f32 as hymba is."""
    from repro_torch.configs import replace
    layers, prompt, steps = DENSE_DECODE
    for seed, arch in enumerate(BIG_ARCHS, start=5):
        base = get_config(arch)
        cfg = replace(base, num_layers=layers)
        res = decode_vs_forward(cfg, prompt, steps, seed=seed)
        hold_decode_vs_forward("dense_decode", arch, res, layers=layers,
                               full_layers=base.num_layers, heads=cfg.num_heads,
                               kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                               embeddings=bool(cfg.frontend), prefill=prompt, decode=steps)
        # the prefill's and the forward's flash, the decode's paged attention
        want = {"flash_attention": 2 * layers, "paged_attention": layers * steps}
        got = {k: res["launches"]["f32"][k] for k in want}
        if got != want:
            raise AssertionError(f"dense_decode {arch} f32: launches {got}, want {want}")


def phase_mla_decode() -> None:
    """deepseek with every expert routed (top_k = num_experts, capacity factor
    2.0, as tests/test_models.py pins it: top-k routing is discontinuous):
    prefill of 32 tokens through flash at D 192, 32 absorbed decode steps over
    the latent cache, one forward over the 64 (the f32 copy takes 65 GB)."""
    from repro_torch.configs import replace
    base = get_config(MLA_ARCH)
    cfg = replace(base, top_k=base.num_experts, capacity_factor=2.0)
    prompt, steps = MLA_DECODE
    res = decode_vs_forward(cfg, prompt, steps, seed=4)
    hold_decode_vs_forward("mla_decode", MLA_ARCH, res, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, prefill=prompt,
                           decode=steps)


def reset_launches() -> None:
    for mod, counter in LAUNCH_COUNTERS.values():
        setattr(mod, counter, 0)


def read_launches() -> dict:
    return {name: getattr(mod, counter) for name, (mod, counter) in LAUNCH_COUNTERS.items()}


@torch.no_grad()
def phase_serve_ssm() -> dict:
    """mamba2-780m at full width: prefill of 512 tokens (two scan chunks of
    256, so the state crosses a chunk boundary on the serving path), 256
    greedy decode steps, and a forward over the 768 = 3 × 256 tokens."""
    cfg = get_config(SSM_ARCH)
    args = ["--arch", SSM_ARCH, "--batch", str(BATCH), "--prompt-len", str(SSM_PROMPT)]
    emit({"phase": "serve_ssm_warmup", "note": "2 decode steps: cuBLAS and allocator "
                                               "warm-up"})
    serve.main(args + ["--gen", "2"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = serve.main(args + ["--gen", str(SSM_GEN)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "paged_attention": 0,
            "ring_attention": 0, "latent_attention": 0,
            "ssd_scan": cfg.num_layers, "ssd_scan_bwd": 0, "adamw": 0}
    if launches != want:
        raise AssertionError(f"SSM serving path launches {launches}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits = res.decode_logits.float()
    if tuple(logits.shape) != (BATCH, SSM_GEN, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"SSM decode logits: shape {tuple(logits.shape)}, "
                             "or not finite")
    # recorded, not held to the bound: at 48 layers the random-weight model
    # amplifies bf16 rounding (the JAX reference as much), see phase_ssm_f32
    full = res.model(torch.cat([res.prompts, res.fed], dim=1))[:, SSM_PROMPT:].float()
    rel = ((full - logits).abs().max() / full.abs().max().clamp(min=1.0)).item()
    del full
    emit({"phase": "serve_ssm", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk, "padded_vocab": cfg.padded_vocab,
          "params": sum(p.numel() for p in res.model.parameters()),
          "batch": BATCH, "prompt": SSM_PROMPT, "gen": SSM_GEN,
          "prefill_s": res.prefill_s, "decode_s": res.decode_s,
          "decode_tok_s": SSM_GEN * BATCH / res.decode_s, "launches": launches,
          "decode_vs_forward_rel_err_bf16": rel, "peak_mem_gb": peak_gb})
    return {"launches": launches, "model": res.model, "prompts": res.prompts,
            "fed": res.fed}


@torch.no_grad()
def phase_ssm_f32(model, prompts, fed) -> None:
    """Decode against the forward with the served weights cast to f32 (in
    place), on the served prompts and fed tokens: prefill of two chunks
    through the kernel, 256 recurrent steps from its final state, and one
    forward over the 768 = 3 × 256 tokens, held to the 0.05 bound."""
    model.float()
    cache = model.init_cache(BATCH, SSM_PROMPT + SSM_GEN)
    model.prefill(prompts, cache)
    dec = torch.stack([model.decode_step(cache, fed[:, i], np.full(BATCH, SSM_PROMPT + i))
                       for i in range(SSM_GEN)], dim=1)
    full = model(torch.cat([prompts, fed], dim=1))[:, SSM_PROMPT:]
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise AssertionError("SSM f32 logits not finite")
    err = (full - dec).abs().amax(dim=(0, 2)) / full.abs().max().clamp(min=1.0)
    rel = err.max().item()
    if not rel < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"SSM decode vs forward in f32: relative error {rel:.4f}")
    emit({"phase": "ssm_f32", "decode_vs_forward_rel_err": rel,
          "rel_err_at_steps": {i: err[i].item() for i in sorted(
              {0, SSM_GEN // 16 - 1, SSM_GEN // 4 - 1, SSM_GEN // 2 - 1, SSM_GEN - 1})}})


def flash_row(dev, gen, B: int, S: int, H: int, Kh: int, D: int, launches: int,
              err: float, case: str, window=None, lse: bool = False) -> dict:
    """The flash kernel's row of the kernels line: causal bf16 prefill of S
    tokens, GQA H/Kh, an optional window; with ``lse`` the training forward,
    which also writes each row's LSE. Its library call is SDPA: with
    ``is_causal`` when every head reads its own KV head and there is no
    window, else with an explicit boolean mask and the KV heads repeated."""
    dt = torch.bfloat16
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt)
    qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    if window is None and H == Kh:
        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                    is_causal=True)
    else:
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=mask)
    elem = torch.finfo(dt).bits // 8
    flash_bytes = (2 * q.numel() + k.numel() + v.numel()) * elem + lse * B * H * S * 4
    flash_flops = fa.flash_work(q.shape, k.shape, True, window)   # QK^T and PV
    fb, fby = bound_ms(flash_bytes, flash_flops, dt)
    if lse:
        def kernel():
            return fa._launch(q, k, v, True, window, with_lse=True)
    else:
        def kernel():
            return fa.flash_attention_op(q, k, v, causal=True, window=window)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: attention_ref(q, k, v, causal=True, window=window),
                              iters=20 if S <= 1024 else 2),
        "bound_ms": fb, "bound_by": fby, "library_ms": device_ms(library),
        "case": case, "shape": {"q": list(q.shape), "kv": list(k.shape), "window": window,
                                "dtype": "bf16", "lse": lse},
    }
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def scan_row(dev, gen, shape: tuple, launches: int, err, case: str,
             training: bool = False) -> dict:
    """The SSD scan's row of the kernels line at (B, L, H, P, N, chunk), f32,
    model-like dt and A, the final state written; with ``training`` the
    training forward (y in f32 on the CUDA cores, the states on the FP64
    tensor cores, cs in f64, the chunk-entry states written), its max |err|
    measured here against
    ``ssd_chunked(..., cs64=True)`` and held to SSD_TOL."""
    B, L, H, P, N, K = shape
    x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
    sb, sby = bound_ms(*ssd_work(B, L, H, P, N, K, states=training), torch.float32)
    if training:
        def kernel():
            return ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)

        def plain():
            return ssd_chunked(x, Bm, Cm, dt, A, chunk=K, return_states=True, cs64=True)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max(max_err(g, w, SSD_TOL, f"ssd training forward {case} {n}")
                  for n, g, w in zip(("y", "h_final", "states"), got, want))
        del got, want
    else:
        def kernel():
            return ssd.ssd_scan_op(x, Bm, Cm, dt, A, chunk=K, return_state=True)

        def plain():
            return ssd_chunked(x, Bm, Cm, dt, A, chunk=K)
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:66",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(kernel), "plain_ms": device_ms(plain),
        "bound_ms": sb, "bound_by": sby, "library_ms": None, "case": case,
        "shape": {"x": list(x.shape), "N": N, "chunk": K, "dtype": "f32", "h_final": True,
                  "states": training},
    }
    if training:    # the bound at the rate of the arithmetic it runs, beside 3×TF32's
        nbytes, flops = ssd_work(B, L, H, P, N, K, states=True)
        row["bound_ms_fp64_tc"] = max(nbytes / HBM_BYTES_PER_S, flops / FP64_TC_FLOPS) * 1e3
        print(f"ssd training forward {case}: {row['ms']:.6f} ms; bound {sb:.6f} ms at "
              f"3×TF32, {row['bound_ms_fp64_tc']:.6f} ms at the FP64 tensor cores and f32 "
              f"CUDA cores it runs")
    del x, Bm, Cm, dt, A
    torch.cuda.empty_cache()
    return row


def scan_bwd_row(dev, gen, shape: tuple, launches: int, case: str) -> dict:
    """The scan backward's row of the kernels line at (B, L, H, P, N, chunk):
    f32, model-like dt and A, from the training instance's states, no h_final
    cotangent (as in training). Held to its plain version (SSD_BWD_TOL, max
    |a − b| / max(|b|, 1) per gradient) and to equal bits on a repeat; its
    max_abs_err is the largest |a − b| of the five gradients."""
    B, L, H, P, N, K = shape
    x, Bm, Cm, dt, A = ssd_inputs(dev, gen, B, L, H, P, N, model_like=True)
    dy = torch.randn(B, L, H, P, generator=gen, device=dev)
    _, _, states = ssd._launch(x, Bm, Cm, dt, A, K, True, with_states=True)
    what = f"ssd bwd row {case}"
    grads = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)
    again = ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{what}: two runs gave different bits")
    plain = ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, None, chunk=K)
    rel = ssd_bwd_rel_errs(grads, plain, what)
    abs_err = max((g - p).abs().max().item() for g, p in zip(grads, plain))
    del grads, again, plain
    nbytes, flops = ssd_bwd_work(B, L, H, P, N, K)
    bb, bby = bound_ms(nbytes, flops, torch.float32)
    _, flops_per_head = ssd_bwd_work(B, L, H, P, N, K, dg_per_head=True)
    row = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:63",
        "launches": launches, "max_abs_err": abs_err, "rel_err": rel,
        "bitwise_repeatable": True,
        "ms": device_ms(lambda: ssd._launch_bwd(x, Bm, Cm, dt, A, states, dy, None, K)),
        "plain_ms": device_ms(lambda: ssd_scan_bwd_ref(x, Bm, Cm, dt, A, states, dy, None,
                                                       chunk=K), iters=3),
        "bound_ms": bb, "bound_by": bby, "library_ms": None,
        "fwd_states_ms": device_ms(lambda: ssd._launch(x, Bm, Cm, dt, A, K, True,
                                                       with_states=True)),
        "bound_ms_fp64_tc": max(nbytes / HBM_BYTES_PER_S, flops / FP64_TC_FLOPS) * 1e3,
        "case": case,
        "shape": {"x": list(x.shape), "N": N, "chunk": K, "dtype": "f32",
                  "dh_final": None, "bytes": nbytes, "flops": flops,
                  "flops_dg_per_head": flops_per_head},
    }
    print(f"ssd backward {case}: {row['ms']:.6f} ms; bound {bb:.6f} ms at 3×TF32, "
          f"{row['bound_ms_fp64_tc']:.6f} ms at the FP64 tensor cores it runs "
          f"({flops / 1e9:.2f} GFLOP; {flops_per_head / 1e9:.2f} with dG met per head: "
          f"{flops_per_head / PEAK_FLOPS[torch.float32] * 1e3:.6f} and "
          f"{flops_per_head / FP64_TC_FLOPS * 1e3:.6f} ms)")
    del x, Bm, Cm, dt, A, dy, states
    torch.cuda.empty_cache()
    return row


def paged_row(q, kv, lengths, plan, live_blocks, launches: int, err: float, case: str,
              plain_iters: int = 20) -> dict:
    """The paged kernel's row of the kernels line, R = 4, bf16. Its library call
    is SDPA over strided views of the pool's first B·pages pages: the same
    function only because every table here is one contiguous, full-length run."""
    B, H, D = q.shape
    P, T, _, Kh, _ = kv.shape
    tokens = int(lengths.sum())
    pages = tokens // B // T
    elem = q.element_size()
    nbytes = (2 * q.numel() + tokens * 2 * Kh * D) * elem \
        + (plan[0].numel() + plan[1].numel() + lengths.numel()) * 4
    pb, pby = bound_ms(nbytes, 4 * D * H * tokens, q.dtype)
    seq = kv[:B * pages].view(B, pages * T, 2, Kh, D)
    k_lib, v_lib = seq[:, :, 0].transpose(1, 2), seq[:, :, 1].transpose(1, 2)
    q_lib = q[:, :, None, :]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: pa.paged_attention(q, kv, None, lengths, pages_per_block=4,
                                                   plan=plan, live_blocks=live_blocks)),
        "plain_ms": device_ms(lambda: pa.paged_attention_plain(
            q, kv, *plan, lengths, pages_per_block=4), iters=plain_iters),
        "bound_ms": pb, "bound_by": pby,
        "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, enable_gqa=H != Kh)),
        "launch_shape": pa.launch_shape(B, Kh, live_blocks or plan[0].shape[1],
                                        pa.sm_count(q.device), 4 * T * 2 * D * elem),
        "case": case, "shape": {"q": list(q.shape), "pool": list(kv.shape),
                                "tokens": tokens, "R": 4, "dtype": str(q.dtype)},
    }


def ring_row(dev, gen, launches: int, err: float) -> dict:
    """The ring kernel's row of the kernels line at ``hymba-1.5b.decode``'s
    shape (B 64, 1024 slots, H 25, Kh 5, D 64, bf16), also at 1 to 16 splits
    there and at B 4 (serve_archs' batch), where ``split_count`` splits. Its
    library call is SDPA with ``enable_gqa`` and the boolean mask over strided
    views of the ring."""
    q, k, v, valid = ring_decode_inputs(dev, gen)
    B, H, D = q.shape
    length, Kh = k.shape[1], k.shape[2]
    scale = D ** -0.5
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + valid.numel()
    rb, rby = bound_ms(nbytes, 4 * D * H * B * length, q.dtype)
    q_lib, k_lib, v_lib, mask = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), \
        valid[:, None, None, :]
    return {
        "name": "ring_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_attention.cu",
        "replaces": "none: src/repro/models/attention.py attention_decode's plain products",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: ra.ring_attention(q, k, v, valid, scale)),
        "plain_ms": device_ms(lambda: ra.ring_attention_plain(q, k, v, valid, scale), iters=5),
        "bound_ms": rb, "bound_by": rby, "bytes": nbytes,
        "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_lib, k_lib, v_lib, attn_mask=mask, enable_gqa=True)),
        "splits": ra.split_count(B * Kh, length, ra.sm_count(dev)),
        "ms_by_splits": {f"B {b}": ring_ms_by_splits(*inputs)
                         for b, inputs in ((B, (q, k, v, valid)),
                                           (4, ring_decode_inputs(dev, gen, B=4)))},
        "case": f"serving: {HYBRID_ARCH} decode",
        "shape": {"q": list(q.shape), "ring": list(k.shape), "dtype": str(q.dtype)},
    }


def ring_ms_by_splits(q, k, v, valid) -> dict:
    """The ring kernel's ms a call at 1 to 16 splits, and the split count
    ``split_count`` picks there."""
    B, _, D = q.shape
    picked = ra.split_count(B * k.shape[2], k.shape[1], ra.sm_count(q.device))
    return {"picked": picked, **{S: device_ms(lambda: ra.ring_attention(
        q, k, v, valid, D ** -0.5, splits=S)) for S in (1, 2, 4, 8, 16)}}


def latent_inputs(dev, gen, B: int, H: int, R: int, dr: int, length: int, lengths, *,
                  layers: int = 1, dtype=torch.bfloat16):
    """q_lat (f32), q_pe, one layer's latent c_kv and rope key k_pe in ``dtype``
    (layer ``layers − 1`` of that many) and the latent cache's mask for
    ``lengths`` tokens cached a sequence (the slots below each count)."""
    lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    valid = torch.arange(length, device=dev)[None, :] < lengths[:, None]
    q_lat = torch.randn(B, H, R, generator=gen, device=dev)
    q_pe = torch.randn(B, H, dr, generator=gen, device=dev).to(dtype)
    c_kv = torch.randn(layers, B, length, R, generator=gen, device=dev).to(dtype)[-1]
    k_pe = torch.randn(layers, B, length, dr, generator=gen, device=dev).to(dtype)[-1]
    return q_lat, q_pe, c_kv, k_pe, valid, lengths


def latent_cell_lengths(dev, seed: int = 0) -> np.ndarray:
    """deepseek-v2-lite-16b.decode's 64 sequences: 1, all 2,560 slots, either
    side of the wrapper's first split boundary, the rest drawn over 1-2,560."""
    B, length = LATENT_DECODE
    S = la.split_count(B, length, la.sm_count(dev))
    per = -(-length // S)
    rng = np.random.default_rng(seed)
    return np.concatenate([[1, length, per, per + 1],
                           rng.integers(1, length + 1, B - 4)])


def latent_scale() -> float:
    """DeepSeek-V2-Lite's score scale as released (the cell's configuration),
    (dn + dr)^-0.5 times YaRN's m²."""
    from repro_torch.configs.deepseek_v2_lite_16b import PUBLISHED as cfg
    from repro_torch.models.layers import softmax_scale
    return softmax_scale(cfg, cfg.qk_nope_dim + cfg.qk_rope_dim)


def latent_errors(out, q_lat, q_pe, c_kv, k_pe, valid, lengths, scale) -> dict:
    """o_lat of the kernel, of the plain f32 version and of two faults (q_lat
    rounded once to bf16; P rounded once to bf16 before P·c_kv), each against
    the f64 oracle: max |err| / max |oracle|."""
    oracle = latent_attention_ref(q_lat, q_pe, c_kv, k_pe, lengths - 1, scale)
    peak = oracle.abs().max()

    def rel(x):
        return ((x.double() - oracle).abs().max() / peak).item()
    plain = la.latent_attention_plain(q_lat, q_pe, c_kv, k_pe, valid, scale)
    q_fault = la.latent_attention_plain(q_lat.bfloat16().float(), q_pe, c_kv, k_pe, valid,
                                        scale)
    c = c_kv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
         + torch.einsum("bhd,bsd->bhs", q_pe.float(), k_pe.float())) * scale
    s = torch.where(valid[:, None, :], s, la.NEG_INF)
    p_fault = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1).bfloat16().float(), c)
    return {"kernel": rel(out), "plain": rel(plain),
            "kernel_vs_plain": ((out - plain).abs().max() / peak).item(),
            "fault_q_lat_bf16": rel(q_fault), "fault_p_bf16": rel(p_fault)}


def latent_edge_cases(dev, gen):
    """The latent kernel's cases beside the cell's shape, in bf16 and f32: each
    instance (R, dr) at its model's heads, H 20 (two CTAs of heads, the second
    with 4), one valid slot, B 1, forced splits of which some hold no valid
    slot, a mask with holes, a cache view at layer 1 of 2. Yields dicts of the
    wrapper's arguments plus ``what``, ``lengths`` (None: the mask is not a
    prefix) and ``splits`` (None: the wrapper's choice)."""
    def case(what, B, H, R, dr, length, lengths, *, splits=None, valid=None, **kw):
        q_lat, q_pe, c_kv, k_pe, mask, lens = latent_inputs(dev, gen, B, H, R, dr, length,
                                                            lengths, dtype=dtype, **kw)
        if valid is not None:
            mask = valid.to(dev)
        return {"what": f"{what}, {str(dtype)[6:]}", "q_lat": q_lat, "q_pe": q_pe,
                "c_kv": c_kv, "k_pe": k_pe, "valid": mask,
                "lengths": None if valid is not None else lens, "splits": splits}

    for dtype in (torch.bfloat16, torch.float32):
        yield case("R 512 dr 64, H 16", 3, 16, 512, 64, 600, [600, 37, 333])
        yield case("R 32 dr 16, H 4 (reduced)", 3, 4, 32, 16, 96, [96, 1, 50])
        yield case("H 20: 16 heads, then 4", 2, 20, 512, 64, 300, [300, 129])
        yield case("one valid slot", 4, 16, 512, 64, 256, [1, 1, 1, 1])
        yield case("B 1", 1, 16, 512, 64, 2560, [2000])
        yield case("forced splits, empty splits", 3, 16, 512, 64, 1024, [700, 5, 100],
                   splits=8)
        holes = torch.rand(2, 400, generator=torch.Generator().manual_seed(1)) < 0.3
        holes[:, 0] = True
        yield case("a mask with holes", 2, 16, 512, 64, 400, [400, 400], valid=holes,
                   splits=2)
        yield case("cache layer 1 of 2", 2, 16, 512, 64, 160, [160, 90], layers=2)


def check_latent_case(case: dict, scale: float) -> dict:
    """One case through the kernel twice: equal bits, and within LATENT_TOL of
    the f64 oracle (a mask with holes: of the plain version), the faults past it."""
    args = [case[n] for n in ("q_lat", "q_pe", "c_kv", "k_pe", "valid")]
    B, H, R = args[0].shape
    length = args[2].shape[1]
    S = case["splits"] or la.split_count(B * -(-H // la.HEADS_PER_CTA), length,
                                         la.sm_count(args[0].device))
    out = la.latent_attention(*args, scale, splits=S)
    again = la.latent_attention(*args, scale, splits=S)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"latent {case['what']}: two runs differ")
    if not torch.isfinite(out).all():
        raise AssertionError(f"latent {case['what']}: non-finite output")
    row = {"case": case["what"], "B": B, "H": H, "R": R, "dr": args[1].shape[-1],
           "slots": length, "dtype": str(args[2].dtype), "splits": S}
    if case["lengths"] is None:
        plain = la.latent_attention_plain(*args, scale)
        err = ((out - plain).abs().max() / plain.abs().max()).item()
        row["kernel_vs_plain"] = err
    else:
        row.update(latent_errors(out, *args, case["lengths"], scale))
        err = row["kernel"]
    if not err <= LATENT_TOL:
        raise AssertionError(f"latent {case['what']}: {err:.3e} past LATENT_TOL {LATENT_TOL}")
    return row


def latent_decode_inputs(dev, gen, seed: int = 0):
    """``deepseek-v2-lite-16b.decode``'s latent cache in one layer: 64 sequences
    of ``latent_cell_lengths`` over 2,560 slots, the model's widths and heads."""
    cfg = get_config(MLA_ARCH)
    B, length = LATENT_DECODE
    return latent_inputs(dev, gen, B, cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_dim, length,
                         latent_cell_lengths(dev, seed))


def latent_work(q_lat, q_pe, c_kv, k_pe, valid, lengths) -> tuple[float, float]:
    """(bytes, flops) of one call over the live slots: each live slot's latent
    and rope key read once, q_lat, q_pe and the mask read, o_lat written;
    2·H·(2R + dr) flops a live slot."""
    B, H, R = q_lat.shape
    dr = q_pe.shape[-1]
    live = int(lengths.sum())
    nbytes = (live * (R + dr) * c_kv.element_size() + 2 * q_lat.numel() * 4
              + q_pe.numel() * q_pe.element_size() + valid.numel())
    return nbytes, 2.0 * H * (2 * R + dr) * live


@torch.no_grad()
def phase_latent(dev: torch.device) -> dict:
    """The latent kernel on the card: at deepseek-v2-lite-16b.decode's latent
    cache (B 64, 2,560 slots, lengths from 1 to 2,560) against the f64 oracle,
    beside the plain f32 version and the two bf16 faults, which must read past
    LATENT_TOL; equal bits on two calls; a CUDA graph's replay equal to the
    eager call; the edge cases (latent_edge_cases); its ms at 1 to 10
    splits, beside the plain version's and its bound. Returns the kernels
    line's row (its launches are serve_archs')."""
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = latent_scale()
    before = la.launches
    q_lat, q_pe, c_kv, k_pe, valid, lengths = latent_decode_inputs(dev, gen)
    args = (q_lat, q_pe, c_kv, k_pe, valid)
    out = la.latent_attention(*args, scale)
    again = la.latent_attention(*args, scale)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError("latent serving shape: two runs differ")
    errs = latent_errors(out, *args, lengths, scale)
    print(f"latent attention at {MLA_ARCH}.decode's shape, max |err| / max |oracle| against "
          "the f64 oracle: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (LATENT_TOL {LATENT_TOL})", flush=True)
    if not errs["kernel"] <= LATENT_TOL:
        raise AssertionError(f"latent serving shape: {errs['kernel']:.3e} past LATENT_TOL")
    for fault in ("fault_q_lat_bf16", "fault_p_bf16"):
        if not errs[fault] > LATENT_TOL:
            raise AssertionError(f"latent {fault}: {errs[fault]:.3e} within LATENT_TOL: the "
                                 "tolerance would pass a bf16-rounded decode")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        la.latent_attention(*args, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = la.latent_attention(*args, scale)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, out):
        raise AssertionError("latent serving shape: a graph's replay differs from the eager call")
    cases = [check_latent_case(case, scale) for case in latent_edge_cases(dev, gen)]
    for case in cases:
        emit({"phase": "latent", **case})
    nbytes, flops = latent_work(*args, lengths)
    bound, bound_by = bound_ms(nbytes, flops, torch.bfloat16)
    S = la.split_count(q_lat.shape[0], c_kv.shape[1], la.sm_count(dev))
    row = {"name": "latent_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/latent_attention.cu",
           "replaces": "none: src/repro/models/mla.py mla_decode's plain f32 products",
           "launches": None, "max_rel_err": errs["kernel"], "errors": errs, "tol": LATENT_TOL,
           "ms": device_ms(lambda: la.latent_attention(*args, scale)),
           "plain_ms": device_ms(lambda: la.latent_attention_plain(*args, scale), iters=5),
           "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
           "splits": S, "live_slots": int(lengths.sum()),
           "ms_by_splits": {n: device_ms(lambda: la.latent_attention(*args, scale, splits=n))
                            for n in (1, 2, 3, 4, 5, 6, 8, 10)},
           "case": f"serving: {MLA_ARCH} decode",
           "shape": {"q_lat": list(q_lat.shape), "c_kv": list(c_kv.shape),
                     "k_pe": list(k_pe.shape), "dtype": str(c_kv.dtype)}}
    emit({"phase": "latent", **row, "phase_launches": la.launches - before})
    return row


LATENT_SERVED = (2718281828, 5.0)     # phase latent_served: the cell's seed, window seconds


@torch.no_grad()
def phase_latent_served() -> dict:
    """deepseek-v2-lite-16b.decode through the benchmark's own harness for a
    short window (bench/lib/harness.py, as ``bench/run.py`` runs the cell): the
    served tokens of the decode that runs the latent kernel against the plain
    reference's (bench/reference/mla_moe.py), ``served_gap`` held to the cell's
    limit."""
    sys.path.insert(0, str(ROOT))
    from bench.lib import harness
    seed, seconds = LATENT_SERVED
    before = la.launches
    res = harness.execute(f"{MLA_ARCH}.decode", seed=seed, seconds=seconds, trace=False)
    out = {"phase": "latent_served", "cell": f"{MLA_ARCH}.decode", "seed": seed,
           "seconds": seconds, "correct": res["correct"], "checks": res["checks"],
           "metrics": res["metrics"], "latent_launches": la.launches - before,
           "peak_mem_gb": res["device"]["memory_peak_bytes"] / 1e9}
    emit(out)
    if not res["correct"]:
        raise AssertionError(f"{MLA_ARCH}.decode not correct: {res['checks']}")
    if out["latent_launches"] == 0:
        raise AssertionError(f"{MLA_ARCH}.decode launched no latent kernel")
    harness.release(torch.device("cuda", 0))
    return out

def adamw_leaves(dev) -> tuple:
    """hymba-1.5b's leaves as one training step meets them (shapes from the
    meta model): bf16 gradients and parameters of seeded draws, f32 moments
    that have seen a step."""
    from repro_torch.models.transformer import Transformer
    shapes = [p.shape for _, p in Transformer(get_config(HYBRID_ARCH), device="meta")
              .named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(4)

    def draw(scale: float, dtype) -> list:
        return [torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16).to(dtype)
                .mul_(scale) for s in shapes]
    return (draw(1e-3, torch.bfloat16), draw(2e-2, torch.bfloat16),
            draw(1e-4, torch.float32), [t.square_() for t in draw(1e-4, torch.float32)])


ADAMW_HYPER = dict(lr=3e-4, bc1=1 - 0.9 ** 3, bc2=1 - 0.95 ** 3, b1=0.9, b2=0.95, eps=1e-8,
                   weight_decay=0.1)


def adamw_check(grads: list, params: list, m: list, v: list) -> dict:
    """One step of ``aw.adamw_fused`` at these leaves held to the plain
    version from the same state, as the card test holds it: the norm within
    1e-6 of ``clip_by_global_norm_plain``'s (both beside the norm summed in
    f64); then ``adamw_plain``, leaf by leaf, on the gradients clipped by the
    plain clip's formula from the kernel's norm: parameters equal in their
    dtype on 99.9 % of elements and one step apart elsewhere, moments within
    2e-6 relative. The update is held at the kernel's norm because m' =
    b1 m + (1 − b1) g cancels to near 0 in some elements, where two norms a
    rounding apart alone give any relative gap. The kernel updates
    ``params`` in place; ``m`` and ``v`` are only read. Returns the errors."""
    from repro_torch.kernels.adamw.ref import adamw_plain, clip_by_global_norm_plain
    p_plain = [p.clone() for p in params]
    m_k, v_k, gn = aw.adamw_fused(grads, params, m, v, **ADAMW_HYPER, max_norm=1.0)
    names = [str(i) for i in range(len(grads))]
    clipped, gn_plain = clip_by_global_norm_plain(dict(zip(names, grads)), 1.0)
    del clipped
    gn_f64 = torch.stack([g.double().square().sum() for g in grads]).sum().sqrt()
    scale = torch.clamp(1.0 / gn.clamp(min=1e-12), max=1.0)   # the plain clip's, max_norm 1
    ulps, unequal, elems, rel = 0, 0, 0, {"m": 0.0, "v": 0.0}
    for i, n in enumerate(names):
        new_m, new_v = adamw_plain({n: grads[i].float() * scale}, {n: m[i]}, {n: v[i]},
                                   {n: p_plain[i]}, **ADAMW_HYPER)
        view = torch.int16 if params[i].dtype == torch.bfloat16 else torch.int32
        gap = (params[i].view(view).long() - p_plain[i].view(view).long()).abs()
        ulps = max(ulps, int(gap.max()))
        unequal += int(gap.count_nonzero())
        elems += gap.numel()
        for got, want, which in ((m_k[i], new_m[n], "m"), (v_k[i], new_v[n], "v")):
            gap = (got - want).abs() / want.abs().clamp(min=1e-30)
            rel[which] = max(rel[which], float(gap.max()))
        del new_m, new_v
    gn, gn_plain, gn_f64 = float(gn), float(gn_plain), float(gn_f64)
    out = {"norm_rel_err": abs(gn - gn_plain) / gn_plain,
           "norm_rel_err_f64": abs(gn - gn_f64) / gn_f64,
           "plain_norm_rel_err_f64": abs(gn_plain - gn_f64) / gn_f64,
           "param_max_ulps": ulps, "param_equal_share": 1 - unequal / elems,
           "m_max_rel_err": rel["m"], "v_max_rel_err": rel["v"]}
    if (out["norm_rel_err"] > 1e-6 or ulps > 1 or out["param_equal_share"] < 0.999
            or rel["m"] > 2e-6 or rel["v"] > 2e-6):
        raise AssertionError(f"adamw at {len(grads)} leaves off the plain version: {out}")
    return out


def adamw_row(dev, launches: int) -> dict:
    """AdamW's row of the kernels line at ``hymba-1.5b.train``'s 611 leaves
    (1.64 B bf16 parameters and gradients, f32 moments): one step held to
    the plain loop's (``adamw_check``); then one step's two launches replayed
    on buffers allocated once (its leaf table too), beside the plain loop's
    step (about 25 launches a leaf) and the library's (``torch._foreach_norm``
    and the norm's few scalar operations, then ``torch._fused_adamw_`` in two
    groups, decay on ``ndim >= 2``), all on the same leaves. The library's
    fused AdamW takes one dtype across its lists, so it runs on f32 copies of
    the parameters and gradients (32 bytes an element, against the kernel's
    24). The bound: 24 bytes an element (g read twice, p, m, v read and
    written once)."""
    from repro_torch.kernels.adamw.ref import adamw_plain, clip_by_global_norm_plain
    grads, params, m, v = adamw_leaves(dev)
    errors = adamw_check(grads, params, m, v)
    torch.cuda.empty_cache()
    pl = aw.plan_of(grads, params)
    m_out, v_out = [torch.empty_like(t) for t in m], [torch.empty_like(t) for t in v]
    table = aw.address_table(dev, grads, params, m, v, m_out, v_out)
    partials = torch.empty(pl.norm_blocks, dtype=torch.float64, device=dev)
    gn = torch.empty((), dtype=torch.float32, device=dev)
    elems = sum(p.numel() for p in params)
    nbytes = elems * (2 * 2 + 2 * 2 + 2 * 4 * 2)
    rb, rby = bound_ms(nbytes, 20 * elems, torch.float32)
    ms = device_ms(lambda: aw.launch_fused(pl, table, partials, gn, **ADAMW_HYPER,
                                           max_norm=1.0), iters=5)
    del m_out, v_out, table
    torch.cuda.empty_cache()
    names = [str(i) for i in range(len(params))]
    g_d, p_d, m_d, v_d = (dict(zip(names, t)) for t in (grads, params, m, v))

    def plain():
        clipped, _ = clip_by_global_norm_plain(g_d, 1.0)
        adamw_plain(clipped, m_d, v_d, p_d, **ADAMW_HYPER)
    plain_ms = device_ms(plain, iters=1, reps=3)
    del g_d, p_d, m_d, v_d
    torch.cuda.empty_cache()
    library_ms = adamw_library_ms(dev, grads, params, m, v)
    return {
        "name": "adamw", "route": "cuda", "source": "src/repro_torch/csrc/adamw.cu",
        "replaces": "none: src/repro/optim/adamw.py update's elementwise ops (XLA's fusions)",
        "launches": launches,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": rb,
        "bound_by": rby, "bytes": nbytes, **errors,
        "case": f"training: {HYBRID_ARCH} AdamW step, {len(params)} leaves",
        "shape": {"leaves": len(params), "elements": elems, "params": "bfloat16",
                  "grads": "bfloat16", "moments": "float32", "chunks": pl.n_chunks,
                  "blocks": pl.update_blocks, "library_params_grads": "float32"},
    }


def adamw_library_ms(dev, grads: list, params: list, m: list, v: list) -> float:
    """Device ms of PyTorch's own multi-tensor AdamW step on these leaves,
    clipped to a global norm of 1: ``torch._foreach_norm`` of the gradients,
    their norm and the clip's scale, then ``torch._fused_adamw_`` (which
    divides each gradient by ``grad_scale``) once for the decayed leaves and
    once for the rest. On f32 copies of ``grads`` and ``params``: the
    library's fused AdamW takes one dtype across its lists. ``m`` and ``v``
    are written in place."""
    g32 = [g.float() for g in grads]
    p32 = [p.float() for p in params]
    step = torch.full((), 3.0, device=dev)
    groups = [[i for i, p in enumerate(p32) if (p.ndim >= 2) == decay] for decay in (True, False)]
    inv_scale = torch.empty((), device=dev)

    def library():
        total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g32)))
        torch.div(total.clamp(min=1e-12), 1.0, out=inv_scale).clamp_(min=1.0)
        for idx, wd in zip(groups, (ADAMW_HYPER["weight_decay"], 0.0)):
            torch._fused_adamw_([p32[i] for i in idx], [g32[i] for i in idx],
                                [m[i] for i in idx], [v[i] for i in idx], [],
                                [step] * len(idx), lr=ADAMW_HYPER["lr"],
                                beta1=ADAMW_HYPER["b1"], beta2=ADAMW_HYPER["b2"],
                                weight_decay=wd, eps=ADAMW_HYPER["eps"], amsgrad=False,
                                maximize=False, grad_scale=inv_scale)
    return device_ms(library, iters=5)


def phase_kernels(dev: torch.device, main_err: dict, launches: dict,
                  kv_spill_launches: int, arch_launches: dict, train_launches: dict,
                  grads_launches: dict, ssm_train_launches: dict,
                  arch_train_launches: dict, more_rows: list) -> None:
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    flash = flash_row(dev, gen, BATCH, PROMPT, H, Kh, D, launches["flash_attention"],
                      main_err[("flash", dt)], "serving: qwen1.5-0.5b prefill")
    B, S, Hl, Dl = LONG_PROMPT
    # same kernel, off the main path: its launches are the main path's
    flash_long = flash_row(dev, gen, B, S, Hl, Hl, Dl, launches["flash_attention"],
                           main_err[("flash_long", dt)], "long prompt, causal")
    B, S, _, Hm, Khm, Dm, _, _ = flash_mla_shape()
    flash_mla = flash_row(dev, gen, B, S, Hm, Khm, Dm,
                          arch_launches[MLA_ARCH]["flash_attention"],
                          main_err[("flash_mla", dt)], f"serving: {MLA_ARCH} prefill, D 192")
    B, S, _, Hh, Khh, Dh, _, W = flash_hybrid_shape()
    flash_hybrid = flash_row(dev, gen, B, S, Hh, Khh, Dh,
                             arch_launches[HYBRID_ARCH]["flash_attention"],
                             main_err[("flash_hybrid", dt)],
                             f"serving: {HYBRID_ARCH} prefill, window {W}", window=W)
    B, S, Hm, Dm = LONG_PROMPT_MLA
    flash_long_mla = flash_row(dev, gen, B, S, Hm, Hm, Dm,
                               arch_launches[MLA_ARCH]["flash_attention"],
                               main_err[("flash_long_mla", dt)], "long prompt, causal, D 192")
    tc = get_config(TRAIN_ARCH)
    flash_train = flash_row(dev, gen, TRAIN_BATCH, TRAIN_SEQ, tc.num_heads, tc.num_kv_heads,
                            tc.head_dim, train_launches["flash_attention"],
                            main_err[("flash_train", dt)],
                            f"training: {TRAIN_ARCH} forward, with the LSE", lse=True)
    flash_bwd = flash_bwd_row(dev, gen, TRAIN_BATCH, TRAIN_SEQ, tc.num_heads,
                              tc.num_kv_heads, tc.head_dim,
                              train_launches["flash_attention_bwd"],
                              f"training: {TRAIN_ARCH} backward (autodiff of "
                              "flash_attention_jnp in the reference)")
    flash_bwd_heads = flash_bwd_row(dev, gen, GRADS_BATCH[ARCH], TRAIN_SEQ, H, Kh, D,
                                    grads_launches[ARCH]["flash_attention_bwd"],
                                    f"train_grads: {ARCH} backward, H = Kh = {H}")
    mc, Bt = get_config(MOE_ARCH), TRAIN_ARCH_RUNS[MOE_ARCH][1]
    flash_bwd_moe = flash_bwd_row(dev, gen, Bt, TRAIN_SEQ, mc.num_heads, mc.num_kv_heads,
                                  mc.head_dim,
                                  arch_train_launches[MOE_ARCH]["flash_attention_bwd"],
                                  f"train_archs: {MOE_ARCH} backward, D {mc.head_dim}")
    B, _, _, Hm, Khm, Dm, _, _ = flash_mla_shape()
    # same kernel, off the main path: its launches are the main path's
    flash_bwd_mla = flash_bwd_row(dev, gen, B, TRAIN_SEQ, Hm, Khm, Dm,
                                  train_launches["flash_attention_bwd"],
                                  f"{MLA_ARCH}'s head dim {Dm}, off the main path")
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt)
    live = -(-(PROMPT + GEN) // (PAGE_TOKENS * 4))   # as the last decode step plans it
    paged = paged_row(pq, pkv, lengths, plan, live, launches["paged_attention"],
                      main_err[("paged", dt)], "serving: qwen1.5-0.5b decode")
    # S = 1 is split_count's choice here; S = 2 beside it
    paged["ms_by_splits"] = {S: device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=4, plan=plan, live_blocks=live, splits=S))
        for S in (1, 2)}
    del pq, pkv, lengths, plan
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt, MOE_ARCH)
    paged_moe = paged_row(pq, pkv, lengths, plan, live,
                          arch_launches[MOE_ARCH]["paged_attention"],
                          main_err[("paged_moe", dt)], f"serving: {MOE_ARCH} decode, D 128")
    del pq, pkv, lengths, plan
    gqa = "qwen2.5-32b"
    pq, pkv, lengths, plan = paged_inputs(dev, gen, dt, gqa)
    paged_gqa = paged_row(pq, pkv, lengths, plan, live,
                          arch_launches[gqa]["paged_attention"],
                          main_err[("paged_gqa", dt)], f"serving: {gqa} decode, G 5, D 128")
    del pq, pkv, lengths, plan
    pq, pkv, lengths, plans = paged_long_inputs(dev, gen)
    B = pq.shape[0]
    paged_long = paged_row(pq, pkv, lengths, plans[4][:2], plans[4][2],
                           launches["paged_attention"], main_err[("paged_long", dt)],
                           "long context, off the main path", plain_iters=2)
    # the same data planned at R = 1 (one descriptor a page): at the wrapper's
    # launch shape (4 KV heads a CTA share a 16 KB stage) and at R = 4's (one
    # head a CTA), where a stage is one page instead of one 4-page run
    sms = pa.sm_count(dev)
    run_bytes = {R: R * pkv.shape[1] * 2 * D * pkv.element_size() for R in (4, 1)}
    shapes = {R: pa.launch_shape(B, Kh, plans[R][2], sms, run_bytes[R]) for R in (4, 1)}
    paged_long["ms_r1"] = device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=1, plan=plans[1][:2],
        live_blocks=plans[1][2]))
    paged_long["ms_r1_one_head_a_cta"] = device_ms(lambda: pa.paged_attention(
        pq, pkv, None, lengths, pages_per_block=1, plan=plans[1][:2], live_blocks=plans[1][2],
        heads_per_cta=1, splits=pa.split_count(B * Kh, plans[1][2], sms)))
    paged_long["descriptors"] = {f"R{R}": int((plans[R][1] > 0).sum()) for R in (4, 1)}
    paged_long["launch_shape"] = {f"R{R}": shapes[R] for R in (4, 1)}
    paged_long["launches_kv_spill"] = kv_spill_launches
    del pq, pkv, lengths, plans
    torch.cuda.empty_cache()
    ring = ring_row(dev, gen, arch_launches[HYBRID_ARCH]["ring_attention"],
                    main_err[("ring", dt)])
    torch.cuda.empty_cache()
    scan = scan_row(dev, gen, ssd_serving_shape(), launches["ssd_scan"],
                    main_err[("ssd", torch.float32)], f"serving: {SSM_ARCH} prefill")
    scan_hybrid = scan_row(dev, gen, ssd_hybrid_shape(),
                           arch_launches[HYBRID_ARCH]["ssd_scan"],
                           main_err[("ssd_hybrid", torch.float32)],
                           f"serving: {HYBRID_ARCH} prefill")
    m, hc = get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    scan_train = scan_row(
        dev, gen, (TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim, m.ssm_state,
                   m.ssm_chunk), ssm_train_launches["ssd_scan"], None,
        f"training: {SSM_ARCH} forward (y f32 CUDA cores, states FP64 tensor cores, cs in "
        "f64, chunk-entry states)",
        training=True)
    scan_bwd = scan_bwd_row(
        dev, gen, (TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim, m.ssm_state,
                   m.ssm_chunk), ssm_train_launches["ssd_scan_bwd"],
        f"training: {SSM_ARCH} backward (autodiff of ssm_train's lax.scan in the "
        "reference)")
    B = GRADS_BATCH[HYBRID_ARCH]
    scan_bwd_hybrid = scan_bwd_row(
        dev, gen, (B, TRAIN_SEQ, hc.ssm_heads, hc.ssm_head_dim, hc.ssm_state, hc.ssm_chunk),
        grads_launches[HYBRID_ARCH]["ssd_scan_bwd"],
        f"train_grads: {HYBRID_ARCH} backward, N {hc.ssm_state}")
    torch.cuda.empty_cache()
    adamw = adamw_row(dev, train_launches["adamw"])
    emit({"kernels": [flash, flash_long, flash_mla, flash_hybrid, flash_long_mla, flash_train,
                      flash_bwd, flash_bwd_heads, flash_bwd_mla, flash_bwd_moe, paged,
                      paged_moe, paged_gqa, paged_long, ring, scan, scan_hybrid, scan_train,
                      scan_bwd, scan_bwd_hybrid, adamw, *more_rows]})


def check_engine_clean(stats: dict, what: str) -> dict:
    """No failed transfer, no struck donor, no disk access: the engine's
    fallbacks must not have carried any part of a run."""
    wc_errors = {n: nic["wc_errors"] for n, nic in stats["nic"].items()}
    paging = {i: c["paging"] for i, c in stats["client"].items()}
    bad = {n: e for n, e in wc_errors.items() if e}
    for i, p in paging.items():
        for key in ("write_failures", "read_failovers", "disk_reads",
                    "disk_writes", "disk_fallback_reads", "evictions"):
            if p[key]:
                bad[f"client {i} {key}"] = p[key]
        if p["failed_donors"]:
            bad[f"client {i} failed_donors"] = p["failed_donors"]
    if stats["fabric"]["faults"]["injected"]:
        bad["injected faults"] = stats["fabric"]["faults"]["injected"]
    if bad:
        raise AssertionError(f"{what}: the engine fell back: {bad}")
    return {"wc_errors": sum(wc_errors.values()),
            "disk": {i: (p["disk_reads"], p["disk_writes"]) for i, p in paging.items()}}


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


@torch.no_grad()
def phase_serve_spill() -> dict:
    """The serving path with the remote-KV tier: the kv_store on the card,
    sequence 0 spilled and fetched while a second client pages to the same
    donors."""
    cfg = get_config(ARCH)
    reset_launches()
    res = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                      "--gen", str(GEN), "--page-tokens", str(PAGE_TOKENS), "--spill",
                      "--donors", "3", "--replication", "2", "--clients", "2"])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * GEN, "ring_attention": 0, "latent_attention": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adamw": 0}
    if launches != want:
        raise AssertionError(f"serve --spill launches {launches}, want {want}")
    sp = res.spill
    if sp.kv.pool.device.type != "cuda":
        raise AssertionError(f"kv_store pool on {sp.kv.pool.device}, not the card")
    after = sp.kv.gather(0)
    if not same_bytes(after, sp.seq0_before):
        raise AssertionError("serve --spill: sequence 0's gather changed over spill/fetch")
    clean = check_engine_clean(sp.stats, "serve --spill")
    client = sp.stats["client"]["0"]["box"]
    emit({"phase": "serve_spill", "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
          "gen": GEN, "launches": launches, "seq0_tokens": after.shape[0],
          "seq0_bytes_exact": True,
          "rdma_ops": sp.stats["nic"]["0"]["rdma_ops"],
          "merge": client["merge"], "poll": client["poll"],
          "bg_pages_per_s": sp.bg_rates, "decode_tok_s": GEN * BATCH / res.decode_s,
          **clean})
    return launches


def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def phase_kv_spill(dev: torch.device) -> int:
    """qwen1.5-0.5b's per-layer K/V at a long context through the engine:
    attention over the pool, every sequence spilled (donors round-robin)
    and fetched back in another order, attention again over the new
    tables; returns the paged kernel's launches in this phase."""
    cfg = get_config(ARCH)
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    (B, S, T), R = LONG_DECODE, 4          # the paged_long row's pool
    features, per_seq = 2 * Kh * D, S // T
    pool_pages = B * per_seq + R - 1
    page_bytes = T * features * 2
    # 3 donors of 256 MiB, the heap arena sized for one whole-pool spill
    spec = box.ClusterSpec(num_donors=3, donor_pages=1 << 16,
                           heap_pages=pool_pages * -(-page_bytes // box.PAGE_SIZE),
                           replication=2, nic_scale=2e-8)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    session = box.open(spec, device=dev)
    open_s = time.perf_counter() - t0
    try:
        kv = session.kv_store(num_pages=pool_pages, page_tokens=T, kv_features=features,
                              dtype=torch.bfloat16)
        for b in range(B):
            kv.add_sequence(b, S)
        # the "kernel" that writes the pool: no synchronize before the spill
        kv.pool.normal_(generator=gen)
        pool = kv.pool.view(pool_pages, T, 2, Kh, D)
        q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)

        def attention():
            table = np.array([kv.tables[b] for b in range(B)], np.int32)
            return table, pa.paged_attention(q, pool, table, lengths, pages_per_block=R)

        reset_launches()
        table0, out0 = attention()
        before = [kv.gather(b).clone() for b in range(B)]
        nbytes = B * per_seq * page_bytes
        spill_ms = host_ms(lambda: [kv.spill(b) for b in range(B)])
        if kv.alloc.free_count != pool_pages:
            raise AssertionError(f"after the spill {pool_pages - kv.alloc.free_count} "
                                 "pool pages are still held")
        # the last two come back to each other's pages, the rest to their own
        order = list(range(B - 2)) + [B - 1, B - 2]
        fetch_ms = host_ms(lambda: [kv.fetch(b) for b in order])
        table1, out1 = attention()
        launches = pa.launches
        exact = [same_bytes(kv.gather(b), before[b]) for b in range(B)]
        if not all(exact):
            raise AssertionError(f"kv_spill: gathers not byte-exact: {exact}")
        same = [bool((table0[b] == table1[b]).all()) for b in range(B)]
        plain = pa.paged_attention_plain(q, pool, *pa.upload_plan(table1, R, dev), lengths,
                                         pages_per_block=R)
        errs = []
        for b in range(B):
            if same[b]:
                if not same_bytes(out1[b], out0[b]):
                    raise AssertionError(f"kv_spill: sequence {b}'s attention changed")
                errs.append(0.0)
            else:
                errs.append(max_err(out1[b], plain[b], PAGED_TOL[torch.bfloat16],
                                    f"kv_spill sequence {b} vs plain"))
        stats = session.stats()
        clean = check_engine_clean(stats, "kv_spill")
        # the copy engine's yardstick: one plain copy_ of the same bytes
        # between the card and pinned host memory, each way
        flat = kv.pool[: B * per_seq].reshape(-1).view(torch.uint8)
        host = torch.empty(flat.numel(), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        d2h_ms = host_ms(lambda: host.copy_(flat))
        h2d_ms = host_ms(lambda: flat.copy_(host))
        # the engine's own copy pattern without the engine: one copy_ a
        # pool page (64 KB), then one wait, as a merged WQE's copies run
        pages_d2h_ms = host_ms(lambda: copy_parts(
            zip(host.view(-1, page_bytes), flat.view(-1, page_bytes))))
    finally:
        session.close()
    client = stats["client"]["0"]["box"]
    nic = stats["nic"][str(session.clients[0])]
    emit({"phase": "kv_spill", "arch": ARCH, "seqs": B, "tokens": S, "page_tokens": T,
          "kv_features": features, "dtype": "bf16", "pool_pages": pool_pages,
          "pool_mib": kv.pool.numel() * 2 / 2**20, "moved_bytes": nbytes,
          "spec": spec.to_dict(), "open_s": open_s,
          "nic_scale": spec.nic_scale,
          "spill_s": spill_ms / 1e3, "spill_gb_s": nbytes / spill_ms / 1e6,
          "fetch_s": fetch_ms / 1e3, "fetch_gb_s": nbytes / fetch_ms / 1e6,
          "copy_d2h_gb_s": nbytes / d2h_ms / 1e6, "copy_h2d_gb_s": nbytes / h2d_ms / 1e6,
          "copy_per_page_d2h_gb_s": nbytes / pages_d2h_ms / 1e6,
          "requests_submitted": client["merge"]["submitted"], "rdma_ops": nic["rdma_ops"],
          "merge_ratio": client["merge"]["submitted"] / max(1, nic["rdma_ops"]),
          "merge": client["merge"], "poll": {x: client["poll"][x] for x in
                                             ("handled", "wakeups", "poll_calls")},
          "paged_launches": launches, "tables_same": same, "max_abs_err": errs,
          "gathers_exact": exact, **clean})
    return launches


# tests/test_model.py's calibration point, verbatim: PU-heavy costs at a
# coarse clock (1 virtual µs = 4 real µs) so the pacers really sleep
CALIBRATION_SPEC = dict(
    num_donors=2, num_clients=4, donor_pages=4096, replication=1,
    serve_workers=1, nic_scale=4e-6, admission="congestion",
    nic_cost={"wqe_proc_us": 400.0, "wire_us_per_page": 5.0,
              "mmio_us": 0.3, "completion_dma_us": 0.5,
              "reg_kernel_us": 0.12, "dma_read_us": 0.5})
CALIBRATION_WORKLOAD = dict(client_ops_per_s=500.0, read_fraction=0.0, pages_per_op=1)
CALIBRATION_BAND = 0.35
CALIBRATION_OPS = 48


def one_write_us(device: str, n: int = 256) -> float:
    """Real µs of one 1-page engine write and its wait, from a buffer on
    ``device`` (a near-zero clock, so the time is the byte move's own)."""
    spec = box.ClusterSpec(num_donors=1, donor_pages=1024, replication=1, nic_scale=2e-8)
    with box.open(spec, device=device) as s:
        eng, donor = s.engine(0), s.donors[0]
        page = torch.zeros(box.PAGE_SIZE, dtype=torch.uint8, device=s.device)
        for k in range(16):
            eng.write(donor, k, page).wait(30)
        t0 = time.perf_counter()
        for k in range(n):
            eng.write(donor, k % 512, page).wait(30)
        return (time.perf_counter() - t0) / n * 1e6


def phase_model() -> None:
    """The analytic backend against the threaded engine, card then CPU
    buffers, at the reference's calibration point and band."""
    t_phase = time.perf_counter()
    spec = box.ClusterSpec(**CALIBRATION_SPEC)
    wl = ModelWorkload(**CALIBRATION_WORKLOAD)
    rows, failed = {}, []
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = run_calibration(spec, wl, ops_per_client=CALIBRATION_OPS, device=device)
        secs = time.perf_counter() - t0
        print(f"model calibration on {device}: {r.agreement()}; "
              f"p99 model/measured {r.model_p99_us:.1f}/{r.measured_p99_us:.1f} us; "
              f"{secs:.3f} s")
        rows[device] = {
            "throughput_ratio": r.throughput_ratio, "latency_ratio": r.latency_ratio,
            "model_ops_per_s": r.model_ops_per_s, "measured_ops_per_s": r.measured_ops_per_s,
            "model_mean_us": r.model_mean_us, "measured_mean_us": r.measured_mean_us,
            "model_p99_us": r.model_p99_us, "measured_p99_us": r.measured_p99_us,
            "model_saturated": r.model_saturated, "measured_shrinks": r.measured_shrinks,
            "seconds": secs}
        if not (r.within(CALIBRATION_BAND) and not r.model_saturated
                and r.measured_shrinks == 0):
            failed.append(f"{device}: {r.agreement()}")
    moves = {device: one_write_us(device) for device in ("cuda", "cpu")}
    wall = time.perf_counter() - t_phase
    print(f"model phase: {wall:.3f} s")
    emit({"phase": "model", "band": CALIBRATION_BAND, "ops_per_client": CALIBRATION_OPS,
          "spec": spec.to_dict(), "workload": wl.to_dict(), "calibration": rows,
          "one_write_real_us": moves, "seconds": wall})
    if failed:
        raise AssertionError(f"calibration outside ±{CALIBRATION_BAND}, saturated or "
                             f"shrunk: {failed}")


def run_captured(fn, argv: list) -> tuple[object, str, float]:
    """``fn(argv)`` with its standard output captured (and echoed)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = fn(argv)
    finally:
        sys.stdout.write(buf.getvalue())
    return res, buf.getvalue(), time.perf_counter() - t0


def ends_with(out: str, line: str, what: str) -> None:
    if not out.rstrip().endswith(line):
        raise AssertionError(f"{what}: did not end on {line!r}")


@torch.no_grad()
def phase_examples() -> None:
    """The example twins on the card, in this process."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples import capacity_plan, quickstart, remote_paging_demo, serve_paged
    t_phase = time.perf_counter()
    cuda = ["--device", "cuda"]
    seconds = {}
    res, out, seconds["quickstart"] = run_captured(quickstart.main, cuda)
    ends_with(out, "QUICKSTART OK", "quickstart")
    paging, out, seconds["remote_paging_demo"] = run_captured(remote_paging_demo.main, cuda)
    ends_with(out, "REMOTE PAGING DEMO OK", "remote_paging_demo")

    cfg = get_reduced(ARCH)
    reset_launches()
    served, out, seconds["serve_paged"] = run_captured(serve_paged.main, cuda)
    torch.cuda.synchronize()
    launches = read_launches()
    ends_with(out, "SERVING DONE", "serve_paged")
    gen = served.decode_logits.shape[1]
    want = {"flash_attention": cfg.num_layers, "flash_attention_bwd": 0,
            "paged_attention": cfg.num_layers * gen, "ring_attention": 0, "latent_attention": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "adamw": 0}
    if launches != want or not launches["paged_attention"]:
        raise AssertionError(f"serve_paged launches {launches}, want {want}")
    if served.spill is None or served.spill.kv.pool.device.type != "cuda" or not same_bytes(
            served.spill.kv.gather(0), served.spill.seq0_before):
        raise AssertionError("serve_paged: the spilled sequence did not come back exact")
    if not torch.isfinite(served.decode_logits.float()).all():
        raise AssertionError("serve_paged: non-finite decode logits")
    del served

    threads = threading.active_count()
    plan, out, seconds["capacity_plan"] = run_captured(capacity_plan.main, cuda)
    if threading.active_count() != threads:
        raise AssertionError(f"capacity_plan started threads: {threads} -> "
                             f"{threading.active_count()}")
    _, cpu_out, _ = run_captured(capacity_plan.main, ["--device", "cpu"])
    if out != cpu_out:
        raise AssertionError("capacity_plan: card and CPU runs printed different plans")
    verdict = ("cheapest plan meeting the premium p99 target: 16 donors x 4 workers "
               "(cost 68, predicted p99 35.9us <= 60.0us)")
    ends_with(out, verdict, "capacity_plan")
    wall = time.perf_counter() - t_phase
    print(f"examples phase: {wall:.3f} s")
    emit({"phase": "examples", "seconds": seconds, "phase_seconds": wall,
          "serve_paged_launches": launches,
          "paging": {k: paging[k] for k in ("hits", "faults", "evictions",
                                             "readable_after_failure")},
          "quickstart": res, "capacity_plan": {
              "best": plan["best"], "cost": plan["cost"], "p99_us": plan["p99_us"],
              "points": len(plan["rows"]),
              "sweep_eval_ms": sum(r["eval_ms"] for r in plan["rows"]),
              "threads_before_after": [threads, threading.active_count()]}})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def flash_bwd_shapes() -> list:
    """(case, B, Sq, Skv, H, Kh, D, causal, window) of the backward's checks:
    the reference suite's flash shapes, rdmabox-paper-100m's training shape,
    qwen1.5-0.5b's heads (H = Kh = 16), hymba's window, deepseek's D 192, and
    the D 128 training shapes: qwen2-moe-a2.7b's (train_archs' B) and the GQA
    groups 5, 7 and 8 of qwen2.5-32b, llava-next-34b and command-r-35b
    (train_grads' B)."""
    tc, qc, hc = get_config(TRAIN_ARCH), get_config(ARCH), get_config(HYBRID_ARCH)

    def training(arch, B):
        c = get_config(arch)
        return (f"{arch} training", B, TRAIN_SEQ, TRAIN_SEQ, c.num_heads, c.num_kv_heads,
                c.head_dim, True, None)

    return ([("reference shape", 2, *s) for s in FLASH_SHAPES] + [
        ("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, tc.num_heads, tc.num_kv_heads,
         tc.head_dim, True, None),
        (f"{ARCH} heads", GRADS_BATCH[ARCH], TRAIN_SEQ, TRAIN_SEQ, qc.num_heads,
         qc.num_kv_heads, qc.head_dim, True, None),
        (f"{HYBRID_ARCH} window", 1, 1280, 1280, hc.num_heads, hc.num_kv_heads, hc.head_dim,
         True, hc.window),
        (f"{MLA_ARCH} D 192", *flash_mla_shape()),
        training(MOE_ARCH, TRAIN_ARCH_RUNS[MOE_ARCH][1])] + [
        training(a, GRADS_BATCH[a]) for a in ("qwen2.5-32b", "llava-next-34b",
                                               "command-r-35b")])


def compare_flash_bwd(dev, gen) -> tuple[list, float]:
    """The forward's LSE and the backward kernel against their plain versions
    in f32 and bf16, the backward run twice and held to equal bits, and the
    forward with the LSE held equal to the forward without it. Returns
    (report, max |err| of the training shape's bf16 forward)."""
    report, fwd_err = [], None
    for case, B, Sq, Skv, H, Kh, D, causal, window in flash_bwd_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Skv, Kh, D, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            what = f"flash bwd {dtype} {case} {(B, Sq, Skv, H, Kh, D, causal, window)}"
            o, lse = fa._launch(q, k, v, causal, window, with_lse=True)
            if not torch.equal(o, fa._launch(q, k, v, causal, window)):
                raise AssertionError(f"{what}: the forward with the LSE differs")
            grads = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            again = fa._launch_bwd(q, k, v, o, lse, do, causal, window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"{what}: two runs gave different bits")
            o_plain, lse_plain = flash_attention_online(
                q, k, v, causal=causal, window=window, q_offset=Skv - Sq, return_lse=True)
            plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                            window=window, q_offset=Skv - Sq)
            tol = FLASH_BWD_TOL[dtype]
            row = {"case": case, "shape": [B, Sq, Skv, H, Kh, D], "causal": causal,
                   "window": window, "dtype": str(dtype), "tol": tol,
                   "lse_max_abs_err": max_err(lse, lse_plain, LSE_TOL, what + " LSE"),
                   "o_max_abs_err": max_err(o, o_plain, FLASH_TOL[dtype], what + " o"),
                   "bitwise_repeatable": True}
            for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
                row[f"{name}_max_abs_err"] = max_err(g, p, tol, f"{what} {name}")
            report.append(row)
            if case == "train" and dtype == torch.bfloat16:
                fwd_err = row["o_max_abs_err"]
            del q, k, v, do, o, lse, grads, again, plain, o_plain, lse_plain
    torch.cuda.empty_cache()
    return report, fwd_err


def train_args(ckpt: Path, steps: int, *extra: str) -> list:
    return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(steps), "--ckpt-every", str(TRAIN_CKPT_EVERY), "--ckpt-dir",
            str(ckpt), "--log-every", "5", *extra]


def train_launch_counts(cfg, steps: int, forwards: int = 1, updates=None) -> dict:
    """The launches of ``steps`` train steps of ``cfg`` (its depth as given):
    ``forwards`` forwards (2 with --remat full) and one backward a step of
    flash in every attention layer and of the scan in every SSM layer (a
    hybrid layer has both); no paged attention; two AdamW launches (the norm,
    then the update of every leaf) for each of ``updates`` optimizer steps
    (``steps`` unless given: 0 for gradients alone)."""
    attn = cfg.num_layers if cfg.uses_attention else 0
    scan = cfg.num_layers if cfg.uses_ssm else 0
    return {"flash_attention": forwards * attn * steps, "flash_attention_bwd": attn * steps,
            "paged_attention": 0, "ring_attention": 0, "latent_attention": 0,
            "ssd_scan": forwards * scan * steps,
            "ssd_scan_bwd": scan * steps, "adamw": 2 * (steps if updates is None else updates)}


def hold_train_launches(what: str, launches: dict, steps: int, forwards: int,
                        cfg=None) -> None:
    want = train_launch_counts(cfg or get_config(TRAIN_ARCH), steps, forwards)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def phase_train() -> dict:
    """``launch.train.main`` at full width (rdmabox-paper-100m, B 8, S 512) with
    --offload, its launches reset just before and held per step just after;
    the loss finite at every step and falling by the reference test's rule.
    Then 2 steps with --remat full (each block's forward runs again in the
    backward). Returns the main run's launches."""
    from repro_torch.launch import train
    cfg = get_config(TRAIN_ARCH)
    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, out, wall = run_captured(train.main, train_args(ckpt, TRAIN_STEPS, "--offload"))
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hold_train_launches("train", launches, TRAIN_STEPS, 1)
    ends_with(out, "TRAINING DONE", "train")
    losses = res.losses
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train: losses {losses}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"train: mean loss of the last 5 steps {last:.4f} not below "
                             f"the first 5's {first:.4f} by {TRAIN_LOSS_DROP}")
    if not res.offload or res.offload["rdma_ops"] <= 0:
        raise AssertionError(f"train --offload: {res.offload}")
    step_s = (res.seconds - res.first_step_s) / (TRAIN_STEPS - 1)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {step_s:.6f} s a step after the first ({res.first_step_s:.3f} s), "
          f"{tokens_a_step / step_s:,.0f} tok/s, peak {peak_gb:.2f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint, offload and flush after "
          f"the last step {wall - res.seconds:.3f} s")
    emit({"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": sum(p.numel() for p in res.model.parameters()),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "step_s": step_s, "first_step_s": res.first_step_s,
          "train_tok_s": tokens_a_step / step_s, "seconds": res.seconds,
          "after_steps_s": wall - res.seconds, "losses": losses.tolist(),
          "mean_first5": first, "mean_last5": last, "launches": launches,
          "offload": res.offload, "peak_mem_gb": peak_gb})
    del res
    torch.cuda.empty_cache()
    reset_launches()
    remat_ckpt = ROOT / "build" / "chip_smoke_train_remat"
    shutil.rmtree(remat_ckpt, ignore_errors=True)
    res, out, _ = run_captured(train.main, train_args(remat_ckpt, 2, "--remat", "full"))
    torch.cuda.synchronize()
    remat = read_launches()
    hold_train_launches("train --remat full", remat, 2, 2)
    if not np.isfinite(res.losses).all():
        raise AssertionError(f"train --remat full: losses {res.losses}")
    emit({"phase": "train_remat", "steps": 2, "launches": remat,
          "losses": res.losses.tolist()})
    del res
    for d in (ckpt, remat_ckpt):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_train_ssm() -> dict:
    """``launch.train.main`` at full width and depth on mamba2-780m, B 8, S 512
    (two scan chunks: the state's gradient crosses a chunk), its launches
    reset just before and held per step just after (48 scan forwards and 48
    scan backwards, nothing else); the loss finite at every step and falling
    by the reference test's rule; step seconds, train tok/s, peak device
    memory. One checkpoint, after the last step. Returns its launches."""
    from repro_torch.launch import train
    cfg = get_config(SSM_ARCH)
    ckpt = ROOT / "build" / "chip_smoke_train_ssm"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, out, wall = run_captured(train.main, [
        "--arch", SSM_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--steps", str(SSM_TRAIN_STEPS), "--ckpt-every", str(SSM_TRAIN_STEPS + 1),
        "--ckpt-dir", str(ckpt), "--log-every", "5"])
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hold_train_launches("train_ssm", launches, SSM_TRAIN_STEPS, 1, cfg)
    ends_with(out, "TRAINING DONE", "train_ssm")
    losses = res.losses
    if len(losses) != SSM_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train_ssm: losses {losses}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"train_ssm: mean loss of the last 5 steps {last:.4f} not "
                             f"below the first 5's {first:.4f} by {TRAIN_LOSS_DROP}")
    step_s = (res.seconds - res.first_step_s) / (SSM_TRAIN_STEPS - 1)
    tokens_a_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train_ssm: {step_s:.6f} s a step after the first ({res.first_step_s:.3f} s), "
          f"{tokens_a_step / step_s:,.0f} tok/s, peak {peak_gb:.2f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint after the last step "
          f"{wall - res.seconds:.3f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "train_ssm", "arch": SSM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk,
          "params": sum(p.numel() for p in res.model.parameters()),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SSM_TRAIN_STEPS,
          "step_s": step_s, "first_step_s": res.first_step_s,
          "train_tok_s": tokens_a_step / step_s, "seconds": res.seconds,
          "after_steps_s": wall - res.seconds, "losses": losses.tolist(),
          "mean_first5": first, "mean_last5": last, "launches": launches,
          "peak_mem_gb": peak_gb})
    del res
    torch.cuda.empty_cache()
    return launches


def frontend_embeds(cfg, tokens: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """A stubbed modality frontend's training input (B, S, d_model) bf16, the
    shape ``launch.steps.data_structs`` gives it: a fixed N(0, 1) codebook of
    ``vocab_size`` rows drawn from ``seed``, looked up at the token ids, so
    the next token is as learnable from the embeddings as from the ids."""
    gen = torch.Generator(device=tokens.device).manual_seed(seed)
    book = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen, device=tokens.device)
    return book[tokens].bfloat16()


def train_inputs(cfg, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """A ``SyntheticTokens`` batch on the card: (token ids, or a frontend
    arch's embeddings; targets)."""
    tokens = torch.from_numpy(batch["tokens"]).long().cuda()
    targets = torch.from_numpy(batch["targets"]).long().cuda()
    return (frontend_embeds(cfg, tokens) if cfg.frontend else tokens), targets


def set_cfg(model, cfg) -> None:
    """Run ``model`` as ``cfg`` from here on (same weights; the MoE reads its
    routing from the config at each call)."""
    model.cfg = cfg
    for blk in model.blocks:
        blk.cfg = cfg


def grads_once(model, tokens, targets, plain: bool, host: bool = False
               ) -> tuple[dict, float, dict]:
    """One forward and backward of ``loss_fn``: (gradient by parameter, loss,
    launches); with ``plain`` flash runs its plain versions on the card; with
    ``host`` the gradients are moved to host memory."""
    from repro_torch.models import loss_fn
    model.zero_grad(set_to_none=True)
    reset_launches()
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, _ = loss_fn(model, tokens, targets)
        loss.backward()
    torch.cuda.synchronize()
    launched = read_launches()
    grads = {}
    for n, p in model.named_parameters():
        grads[n] = p.grad.cpu() if host and p.grad is not None else p.grad
        p.grad = None
    return grads, float(loss.detach()), launched


def unreached_leaf(cfg, name: str) -> bool:
    """A leaf the loss reaches in neither path, nor in the reference: an SSM
    block's norm_ffn (it has no FFN but carries the leaf), and a frontend
    arch's untied embed (its inputs are embeddings)."""
    return ((cfg.family == "ssm" and name.endswith(".norm_ffn"))
            or (bool(cfg.frontend) and name == "embed"))


def phase_train_grads(smi: str) -> dict:
    """Every parameter's gradient through the kernels against the gradient
    with flash and the scan swapped for their plain versions on the card, one
    step at full width of every arch of GRADS_BATCH at its depth
    (GRADS_LAYERS): printed in bf16 (held finite; a MoE arch routes its own
    top-k), held on an f32 copy (finite, nonzero, within TRAIN_GRAD_TOL in
    relative norm; a MoE arch routes every token to every expert), each
    arch's launches held in both. Returns each arch's kernel launches in its
    bf16 step."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import init_transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch, B in GRADS_BATCH.items():
        cfg = grads_cfg(arch)
        host = arch in GRADS_ON_HOST
        print(f"train_grads {arch}: {cfg.num_layers} of {get_config(arch).num_layers} "
              f"layers, B {B}, S {TRAIN_SEQ}, {cfg.param_count() / 1e9:.2f} B parameters, "
              f"f32 hold {grads_bytes(arch) / 1e9:.1f} GB on the card"
              + (" (kernel gradients on the host)" if host else ""))
        batch = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, B)).batch_at(0)
        tokens, targets = train_inputs(cfg, batch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
        out = {"phase": "train_grads", "arch": arch, "layers": cfg.num_layers,
               "full_layers": get_config(arch).num_layers, "batch": B, "seq": TRAIN_SEQ,
               "params": cfg.param_count(), "reckoned_gb": grads_bytes(arch) / 1e9,
               "kernel_grads_on_host": host, "embeddings": bool(cfg.frontend),
               "tol_f32": TRAIN_GRAD_TOL, "card": smi}
        for dtype in ("bf16", "f32"):
            if dtype == "f32":
                model.float()
                set_cfg(model, grads_cfg(arch, routed=True))
            kernel, loss_k, launched_k = grads_once(model, tokens, targets, plain=False,
                                                    host=host and dtype == "f32")
            plain, loss_p, launched_p = grads_once(model, tokens, targets, plain=True)
            want = train_launch_counts(cfg, 1, updates=0)
            if launched_k != want or any(launched_p.values()):
                raise AssertionError(f"{arch} {dtype}: launches {launched_k} with the "
                                     f"kernels, {launched_p} without")
            if not (np.isfinite(loss_k) and np.isfinite(loss_p)):
                raise AssertionError(f"{arch} {dtype}: loss {loss_k} vs plain {loss_p}")
            errs, norms, unreached = {}, {}, []
            for name, g in kernel.items():
                p = plain[name]
                if g is None and p is None and unreached_leaf(cfg, name):
                    unreached.append(name)
                    continue
                if g is None or p is None:
                    raise AssertionError(f"{arch} {dtype}: {name} got no gradient")
                gf, pf = g.float().to(p.device), p.float()
                if not torch.isfinite(gf).all():
                    raise AssertionError(f"{arch} {dtype} {name}: non-finite gradient")
                norms[name] = float(gf.norm())
                errs[name] = float((gf - pf).norm() / pf.norm().clamp(min=1e-30))
                if dtype == "f32" and not (norms[name] > 0 and errs[name] <= TRAIN_GRAD_TOL):
                    raise AssertionError(f"{arch} f32 {name}: norm {norms[name]:.3e}, "
                                         f"relative error {errs[name]:.3e}")
                del gf, pf
            worst = max(errs, key=errs.get)
            print(f"train_grads {arch} {dtype}: {len(errs)} parameters, worst relative "
                  f"error {errs[worst]:.3e} ({worst}), loss {loss_k:.6f} vs plain "
                  f"{loss_p:.6f}, top_k {model.cfg.top_k}"
                  + (" (held)" if dtype == "f32" else "") + f" [{smi}]")
            out[dtype] = {"parameters": len(errs), "unreached": unreached,
                          "max_rel_err": errs[worst], "top_k": model.cfg.top_k,
                          "capacity_factor": model.cfg.capacity_factor,
                          "worst": worst, "min_grad_norm": min(norms.values()),
                          "loss_kernels": loss_k, "loss_plain": loss_p,
                          "mixer_rel_err": {n: e for n, e in errs.items()
                                            if n.startswith("blocks.0.")
                                            and (".attn." in n or ".ssm." in n
                                                 or ".mla." in n or ".moe." in n)},
                          "launches": launched_k}
            launches.setdefault(arch, launched_k)
            del kernel, plain
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit(out)
        del model, tokens, targets
        torch.cuda.empty_cache()
    return launches


def phase_train_archs(smi: str) -> dict:
    """30 steps of ``launch.steps.build_train_step`` (the step ``launch.train``
    runs) for each arch of TRAIN_ARCH_RUNS at full width and its depth, real
    top-k routing, ``SyntheticTokens`` (a frontend arch on their codebook
    embeddings), no checkpoint: the loss finite at every step and the mean of
    the last 5 below the first 5's by TRAIN_LOSS_DROP, one flash forward and
    backward an attention layer a step; step seconds, train tok/s, peak
    memory. Returns arch → launches."""
    from repro_torch.configs import RunConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_transformer
    from repro_torch.optim import adamw
    out = {}
    for arch, (_, B) in TRAIN_ARCH_RUNS.items():
        cfg = train_arch_cfg(arch)
        steps = TRAIN_STEPS
        run = RunConfig(total_steps=steps, warmup_steps=max(10, steps // 10))
        data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, B, seed=run.seed))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_transformer(cfg, seed=run.seed, device="cuda").requires_grad_(True)
        opt = adamw.init(dict(model.named_parameters()), run)
        step_fn = build_train_step(cfg, run)
        losses = []
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(steps):
            tokens, targets = train_inputs(cfg, data.batch_at(step))
            opt, metrics = step_fn(model, opt, {"tokens": tokens, "targets": targets})
            losses.append(metrics["loss"])
            if step == 0:
                torch.cuda.synchronize()
                first_step_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hold_train_launches(f"train_archs {arch}", launches, steps, 1, cfg)
        losses = np.array([float(x) for x in losses])
        if not np.isfinite(losses).all():
            raise AssertionError(f"train_archs {arch}: losses {losses}")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        if not last < first - TRAIN_LOSS_DROP:
            raise AssertionError(f"train_archs {arch}: mean loss of the last 5 steps "
                                 f"{last:.4f} not below the first 5's {first:.4f} by "
                                 f"{TRAIN_LOSS_DROP}")
        step_s = (seconds - first_step_s) / (steps - 1)
        tok_s = B * TRAIN_SEQ / step_s
        print(f"train_archs {arch}: {cfg.num_layers} of {get_config(arch).num_layers} "
              f"layers, B {B}, S {TRAIN_SEQ}, {step_s:.6f} s a step after the first "
              f"({first_step_s:.3f} s), {tok_s:,.0f} tok/s, peak {peak_gb:.2f} GB "
              f"(reckoned {train_bytes(arch) / 1e9:.2f} GB of state), loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} [{smi}]")
        emit({"phase": "train_archs", "arch": arch, "family": cfg.family,
              "layers": cfg.num_layers, "full_layers": get_config(arch).num_layers,
              "d_model": cfg.d_model, "params": cfg.param_count(), "top_k": cfg.top_k,
              "embeddings": bool(cfg.frontend), "batch": B, "seq": TRAIN_SEQ,
              "steps": steps, "step_s": step_s, "first_step_s": first_step_s,
              "train_tok_s": tok_s, "seconds": seconds, "losses": losses.tolist(),
              "mean_first5": first, "mean_last5": last, "launches": launches,
              "peak_mem_gb": peak_gb, "reckoned_gb": train_bytes(arch) / 1e9, "card": smi})
        out[arch] = launches
        del model, opt, step_fn, metrics
        torch.cuda.empty_cache()
    return out


def phase_moe_repeat() -> None:
    """The MoE layer repeats bit for bit on the card: ``loss_fn``'s forward and
    backward of qwen2-moe-a2.7b at full width (depth cut to MOE_LAYERS) twice
    on the same weights and batch, the loss and every parameter's gradient
    equal in every bit. Its combine and the dispatch's backward are gathers
    summed over each token's slots in a fixed order (``models/moe.py``);
    ``index_add_`` there would add with atomics."""
    from repro_torch.configs import replace
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import init_transformer, loss_fn
    full = get_config(MOE_ARCH)
    cfg = replace(full, num_layers=MOE_LAYERS)
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, MOE_BATCH)).batch_at(0)
    tokens = torch.from_numpy(batch["tokens"]).long().cuda()
    targets = torch.from_numpy(batch["targets"]).long().cuda()
    torch.cuda.empty_cache()
    model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach().clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    differ = [n for n, g in grads_a.items() if not torch.equal(g, grads_b[n])]
    if not torch.equal(loss_a, loss_b) or differ or set(grads_a) != set(grads_b):
        raise AssertionError(f"moe_repeat: loss {loss_a.item()!r} then {loss_b.item()!r}, "
                             f"gradients that differ: {differ[:5]}")
    moe_grads = [n for n in grads_a if ".moe." in n]
    if not moe_grads or not all(torch.isfinite(grads_a[n]).all() for n in moe_grads):
        raise AssertionError(f"moe_repeat: MoE gradients {moe_grads[:5]}")
    print(f"moe_repeat: {MOE_ARCH} at depth {MOE_LAYERS} of {full.num_layers} (full width), "
          f"B {MOE_BATCH}, S {TRAIN_SEQ}: loss and {len(grads_a)} gradients equal in every "
          f"bit across two forward and backward runs")
    emit({"phase": "moe_repeat", "arch": MOE_ARCH, "layers": MOE_LAYERS,
          "full_layers": full.num_layers, "d_model": cfg.d_model,
          "experts": cfg.num_experts, "top_k": cfg.top_k, "batch": MOE_BATCH,
          "seq": TRAIN_SEQ, "loss": float(loss_a), "gradients": len(grads_a),
          "moe_gradients": len(moe_grads), "bitwise_equal": True})
    del model, runs, grads_a, grads_b
    torch.cuda.empty_cache()


def phase_train_resume() -> None:
    """Bit-exact resume on the card: rdmabox-paper-100m's width with 2 layers,
    6 straight steps against 3, a checkpoint, a new process state restored
    from it, and 3 more; ``torch.equal`` on every parameter and moment."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import RunConfig, replace
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_transformer
    from repro_torch.optim import adamw
    cfg = replace(get_config(TRAIN_ARCH), num_layers=2)
    run = RunConfig(learning_rate=3e-4, total_steps=6, warmup_steps=2)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    root = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(root, ignore_errors=True)

    def steps(start: int, stop: int, ckpt: Checkpointer, resume: bool):
        model = init_transformer(cfg, seed=0, device="cuda").requires_grad_(True)
        params = dict(model.named_parameters())
        opt = adamw.init(params, run)
        if resume:
            at, (saved, opt), _ = ckpt.restore_latest((params, opt))
            if at != start:
                raise AssertionError(f"train_resume: restored step {at}, want {start}")
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
        step_fn = build_train_step(cfg, run)
        for step in range(start, stop):
            opt, _ = step_fn(model, opt, data.batch_at(step))
        ckpt.save(stop, (params, opt))
        return model, opt

    straight, opt_a = steps(0, 6, Checkpointer(str(root / "a"), keep=1), False)
    ck = Checkpointer(str(root / "b"), keep=1)
    steps(0, 3, ck, False)
    resumed, opt_b = steps(3, 6, ck, True)
    torch.cuda.synchronize()
    params = [n for (n, a), b in zip(straight.named_parameters(), resumed.parameters())
              if not torch.equal(a, b)]
    moments = [n for n in opt_a.m if not (torch.equal(opt_a.m[n], opt_b.m[n])
                                          and torch.equal(opt_a.v[n], opt_b.v[n]))]
    shutil.rmtree(root, ignore_errors=True)
    if params or moments:
        raise AssertionError(f"train_resume: not bit-exact: parameters {params}, "
                             f"moments {moments}")
    emit({"phase": "train_resume", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": "6 straight vs 3 + resume 3", "bit_exact": True,
          "parameters": len(list(straight.parameters()))})
    del straight, resumed, opt_a, opt_b
    torch.cuda.empty_cache()


def flash_bwd_row(dev, gen, B: int, S: int, H: int, Kh: int, D: int, launches: int,
                  case: str) -> dict:
    """A row of the kernels line for the flash backward: causal bf16, S
    tokens, GQA H/Kh, head dim D. Its max |err| is against the plain backward
    on the same inputs, held to FLASH_BWD_TOL. Bound: q, k, v, o, dO, LSE, Δ
    read and dq, dk, dv written once, and five products of 2·D flops a
    visible (query, key) pair. Library: the backward of
    ``scaled_dot_product_attention`` (flash, ``is_causal``) on the same
    tensors with the KV heads repeated (its dk, dv stay per query head): a
    CUDA graph of its forward and backward less one of its forward alone."""
    dt = torch.bfloat16
    q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn(B, S, Kh, D, generator=gen, device=dev).to(dt) for _ in range(2))
    o, lse = fa._launch(q, k, v, True, None, with_lse=True)
    what = f"flash bwd row {case}"
    grads = fa._launch_bwd(q, k, v, o, lse, do, True, None)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do)
    err = max(max_err(g, p, FLASH_BWD_TOL[dt], f"{what} {n}")
              for n, g, p in zip(("dq", "dk", "dv"), grads, plain))
    del grads, plain
    elem = torch.finfo(dt).bits // 8
    nbytes = (4 * q.numel() + 4 * k.numel()) * elem + 2 * lse.numel() * 4
    flops = fa.flash_work(q.shape, k.shape, True, None) * 5 // 2
    bb, bby = bound_ms(nbytes, flops, dt)
    qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    with torch.no_grad():
        sdpa_fwd_ms = device_ms(sdpa)
    sdpa_both_ms = device_ms(sdpa_fwd_bwd)
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:65",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: fa._launch_bwd(q, k, v, o, lse, do, True, None)),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)),
        "bound_ms": bb, "bound_by": bby, "library_ms": sdpa_both_ms - sdpa_fwd_ms,
        "library_fwd_bwd_ms": sdpa_both_ms, "library_fwd_ms": sdpa_fwd_ms,
        "case": case,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "dtype": "bf16",
                  "bytes": nbytes, "flops": flops},
    }
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def last_launch(*mods):
    """Within the block, each module's ``_launch`` keeps the arguments of its
    last call: yields {module: [args, kwargs]}."""
    saved, seen = {m: m._launch for m in mods}, {m: [] for m in mods}

    def keeper(m):
        def launch(*args, **kw):
            seen[m][:] = [args, kw]
            return saved[m](*args, **kw)
        return launch

    for m in mods:
        m._launch = keeper(m)
    try:
        yield seen
    finally:
        for m in mods:
            m._launch = saved[m]


def kernel_at_step(kernel: str, args: tuple, what: str) -> dict:
    """The kernel once more on the inputs its last launch in a step had, against
    its plain version on the same inputs, at the tolerance ``kernels_vs_plain``
    holds it to (f32 products on the plain side)."""
    tf32, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, False
    try:
        if kernel == "flash_attention":
            q, k, v, causal, window = args[:5]
            tol = FLASH_TOL[q.dtype]
            out = fa._launch(q, k, v, causal, window)
            errs = {"out": max_err(out, flash_attention_online(
                q, k, v, causal=causal, window=window, q_offset=k.shape[1] - q.shape[1]),
                tol, what)}
            shape = [list(q.shape), list(k.shape)]
        elif kernel == "paged_attention":
            q, kv, starts, valid, lengths, R = args[:6]
            tol = PAGED_TOL[q.dtype]
            errs = {"out": max_err(pa._launch(*args), pa.paged_attention_plain(
                q, kv, starts, valid, lengths, pages_per_block=R), tol, what)}
            shape = [list(q.shape), list(kv.shape), int(lengths.max())]
        else:
            x, Bm, Cm, dt, A, chunk = args[:6]
            tol = SSD_SERVING_TOL
            y, h = ssd._launch(x, Bm, Cm, dt, A, chunk, True)
            y_plain, h_plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=chunk)
            errs = {"y": max_err(y, y_plain, tol, what),
                    "h_final": max_err(h, h_plain, tol, what + " h_final")}
            shape = [list(x.shape), Bm.shape[-1], chunk]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"kernel": kernel, "shape": shape, "tol": tol, "max_abs_err": errs}


def f32_copy(model):
    """An f32 copy of ``model`` on the card (the original keeps its dtypes)."""
    import copy
    return copy.deepcopy(model).float()


def steps_prefill(model, mesh, cfg, shape, run, tokens, kernel):
    """One timed prefill through ``build_prefill_step``; the kernel at the
    step's inputs against its plain version, and the step's logits on an
    f32 copy against ``Transformer.prefill`` with the plain versions
    swapped in. Returns (seconds, launches, peak GB, checks)."""
    from repro_torch.launch.steps import build_prefill_step, place_model
    step, _, (p_shard,) = build_prefill_step(cfg, shape, run, mesh)
    place_model(model, p_shard, mesh, local=True)
    mod = LAUNCH_COUNTERS[kernel][0]
    with last_launch(mod) as seen:
        step(model, {"tokens": tokens})            # warm-up: cuBLAS, allocator
    at_step = kernel_at_step(kernel, seen[mod][0], f"steps {cfg.name} {kernel} at the step")
    del seen, _
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    del logits, cache
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    m32 = f32_copy(model)
    got, cache = step(m32, {"tokens": tokens})
    del cache
    with plain_kernels():
        want = m32.prefill(tokens.to_local(), m32.init_cache(*tokens.shape))
    err = rel_err(want, got)
    del m32, got, want
    torch.cuda.empty_cache()
    if not err < DECODE_VS_FORWARD_TOL:
        raise AssertionError(f"steps {cfg.name} prefill in f32 vs Transformer.prefill "
                             f"with the plain versions: {err:.4f}")
    return seconds, launches, peak, {"kernel_at_step": at_step,
                                     "f32_vs_plain_prefill": err}


def decode_run(step, model, cache, token, start: int, steps: int) -> list:
    """``steps`` decode steps from position ``start``: each step's logits."""
    return [step(model, cache, token, np.full(token.shape[0], start + i))[0]
            for i in range(steps)]


def steps_decode(model, mesh, cfg, shape, tokens, steps, kernel, gen):
    """``steps`` timed decode steps through ``build_decode_step`` on a cache
    of ``shape.seq_len`` positions filled at random; with a kernel, the kernel
    at the step's inputs against its plain version, and every step's logits
    on an f32 copy against the same steps with the plain versions swapped in
    (each step writes its own slot before it reads the cache and later
    slots lie past its length, so the second run reads what the first did).
    Returns (seconds, launches, peak GB, checks)."""
    from repro_torch.launch.steps import build_decode_step, place_model
    from repro_torch.models.transformer import cache_tensors
    step, (_, _), (p_shard,) = build_decode_step(cfg, shape, mesh)
    place_model(model, p_shard, mesh, local=True)
    batch, start = tokens.shape[0], shape.seq_len - steps - 1

    def filled(m):
        cache = m.init_cache(batch, shape.seq_len)
        for t in cache_tensors(cache).values():
            t.normal_(generator=gen).mul_(0.1)
        return cache

    cache = filled(model)
    mods = (LAUNCH_COUNTERS[kernel][0],) if kernel else ()
    with last_launch(*mods) as seen:
        step(model, cache, tokens[:, 0], np.full(batch, start))       # warm-up
    checks = {}
    if kernel:
        checks["kernel_at_step"] = kernel_at_step(kernel, seen[mods[0]][0],
                                                  f"steps {cfg.name} {kernel} at the step")
    del seen
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = decode_run(step, model, cache, tokens[:, 0], start + 1, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for lg in logits:
        if tuple(lg.shape) != (batch, cfg.padded_vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"steps {cfg.name}: decode logits {tuple(lg.shape)} "
                                 "or not finite")
    del cache, logits
    torch.cuda.empty_cache()
    if kernel:
        m32 = f32_copy(model)
        cache = filled(m32)
        step(m32, cache, tokens[:, 0], np.full(batch, start))
        got = decode_run(step, m32, cache, tokens[:, 0], start + 1, steps)
        # the steps replayed CUDA graphs that hold the kernels; a cast drops them,
        # so the plain run warms up and captures the plain versions anew
        m32.float()
        with plain_kernels():
            want = decode_run(step, m32, cache, tokens[:, 0], start + 1, steps)
        checks["f32_vs_plain_decode"] = max(rel_err(w, g) for w, g in zip(want, got))
        del m32, cache, got, want
        torch.cuda.empty_cache()
        if not checks["f32_vs_plain_decode"] < DECODE_VS_FORWARD_TOL:
            raise AssertionError(f"steps {cfg.name} decode in f32 vs the plain versions: "
                                 f"{checks['f32_vs_plain_decode']:.4f}")
    return seconds, launches, peak, checks


@torch.no_grad()
def phase_steps(smi: str) -> dict:
    """``STEP_RUNS`` through ``launch.steps`` on a 1×1 mesh: seconds, bound,
    share, launches, peak memory, the kernel at the step's own inputs against
    its plain version, the step against the plain versions on an f32 copy
    (module docstring, phase 22)."""
    import dataclasses

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.distributed.sharding import batch_spec, distribute, placements
    from repro_torch.launch.dryrun import roofline_of
    from repro_torch.launch.mesh import close_mesh, make_local_mesh
    from repro_torch.models import init_transformer
    mesh = make_local_mesh(1, 1)
    run, out, models = RunConfig(), {}, {}
    try:
        for arch, shape_name, batch, steps, kernel, why in STEP_RUNS:
            cfg = get_config(arch)
            shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
            bound = roofline_of(cfg, shape, run)           # on meta, one card
            if arch not in models:
                models.clear()
                torch.cuda.empty_cache()
                models[arch] = init_transformer(cfg, seed=0, device="cuda")
            model = models[arch]
            gen = torch.Generator(device="cuda").manual_seed(0)
            tokens = torch.randint(0, cfg.vocab_size, (batch, shape.seq_len if not steps
                                                       else 1), generator=gen, device="cuda")
            tokens = distribute(tokens, mesh, placements(batch_spec(mesh, batch), mesh))
            if steps == 0:
                seconds, launches, peak, checks = steps_prefill(model, mesh, cfg, shape, run,
                                                                tokens, kernel)
                bound_s = bound.floor_s
            else:
                seconds, launches, peak, checks = steps_decode(model, mesh, cfg, shape,
                                                               tokens, steps, kernel, gen)
                bound_s = bound.floor_s * steps
            if kernel is not None and not launches[kernel] > 0:
                raise AssertionError(f"steps {arch} {shape_name}: {kernel} never launched "
                                     f"({launches})")
            row = {"phase": "steps", "arch": arch, "shape": shape_name, "batch": batch,
                   "seq_len": shape.seq_len, "decode_steps": steps, "cut": why,
                   "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   "seconds": seconds, "bound_s": bound_s,
                   "bound_by": "compute" if bound.compute_s >= bound.min_memory_s
                   else "min_bytes",
                   "share_of_bound": bound_s / seconds,
                   "bound_terms_s": {"compute": bound.compute_s,
                                     "min_memory": bound.min_memory_s,
                                     "unfused_memory": bound.memory_s},
                   "counted": {"flops": bound.hlo_flops, "f32_flops": bound.f32_flops,
                               "unfused_bytes": bound.hlo_bytes,
                               "min_bytes": bound.min_bytes,
                               "kernels": bound.memory_stats["kernels"]},
                   "launches": launches, "checks": checks, "held_at": DECODE_VS_FORWARD_TOL,
                   "peak_mem_gb": peak, "card": smi}
            print(f"steps {arch} {shape_name} B {batch}: {seconds:.6f} s, bound "
                  f"{bound_s:.6f} s ({row['bound_by']}), share {row['share_of_bound']:.4f}, "
                  f"launches {launches}, peak {peak:.2f} GB, checks {checks} [{smi}]")
            emit(row)
            out[(arch, shape_name)] = launches
    finally:
        models.clear()
        close_mesh()
        torch.cuda.empty_cache()
    return out


def opt_variants(cfg) -> dict:
    """The ``optimized`` phase's configs of ``cfg`` by name: "base" (no knob),
    each knob of OPT_KNOBS alone and "opt" (the port's ``optimize(cfg)``,
    DEFAULT_ON), each with the name of the earlier variant whose config it
    equals (run once, under that name) or None."""
    from repro_torch.configs.optimized import optimize
    named = {"base": cfg, **{k: optimize(cfg, only={k}) for k in OPT_KNOBS},
             "opt": optimize(cfg)}
    out: dict = {}
    for name, c in named.items():
        out[name] = (c, next((n for n, (o, same) in out.items() if same is None and o == c),
                             None))
    return out


def opt_model(cfg, mesh, f32: bool):
    """``init_transformer(cfg, seed=0)`` (in f32 with ``f32``) with its
    parameters DTensors on ``mesh`` by the sharding rules, as the dry run
    places them: (model, the moments' placements)."""
    from repro_torch.launch.steps import place_model, shardings
    from repro_torch.models import init_transformer
    model = init_transformer(cfg, seed=0, device="cuda")
    if f32:
        model = model.float()
    p_shard, m_shard = shardings(cfg, model, mesh)
    place_model(model, p_shard, mesh, local=False)
    return model, m_shard


def on_mesh(t: torch.Tensor, mesh):
    """``t`` as a DTensor on ``mesh``, its batch split as ``batch_spec`` says."""
    from repro_torch.distributed.sharding import batch_spec, distribute, placements
    return distribute(t, mesh, placements(batch_spec(mesh, t.shape[0]), mesh))


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value; anything else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@contextlib.contextmanager
def knob_paths():
    """Within the block, the times each knob's own code ran: {"moe": MoE
    layers dispatched shard-locally (``_moe_shard_map`` not ``None``),
    "mla_lat": MLA decode scores reduced as a partial sum}."""
    from repro_torch.models import mla, moe
    saved, ran = (moe._moe_shard_map, mla.settle), {"moe": 0, "mla_lat": 0}

    def shard_map(*args):
        out = saved[0](*args)
        ran["moe"] += out is not None
        return out

    def settle(t):
        ran["mla_lat"] += 1
        return saved[1](t)

    moe._moe_shard_map, mla.settle = shard_map, settle
    try:
        yield ran
    finally:
        moe._moe_shard_map, mla.settle = saved


def knob_runs_wanted(cfg, steps: int) -> dict:
    """``knob_paths``' counts for ``opt_serve`` then ``opt_train`` of ``cfg``:
    the MoE in every layer of the prefill step, the prefill filling the
    decode cache, each decode step and the train step's forward; MLA's
    partial sum in every layer of each decode step."""
    return {"moe": cfg.num_layers * (steps + 3) if cfg.moe_shard_map else 0,
            "mla_lat": cfg.num_layers * steps if cfg.mla_latent_psum else 0}


def opt_serve(model, mesh, cfg, tokens, run) -> tuple[list, dict, dict]:
    """``build_prefill_step`` over tokens[:, :prompt], then OPT_RUN's decode
    steps through ``build_decode_step`` on a cache of prompt + steps filled by
    the same prefill, every input a DTensor on ``mesh``: (the prefill's and
    every step's logits, launches of the prefill step and of the decode
    steps, host seconds of each)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import (_inputs, build_decode_step, build_prefill_step,
                                          dtensor_mode)
    B, prompt, steps = OPT_RUN
    prefill, _, _ = build_prefill_step(cfg, ShapeConfig("p", prompt, B, "prefill"), run, mesh)
    decode, _, _ = build_decode_step(cfg, ShapeConfig("d", prompt + steps, B, "decode"), mesh)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [prefill(model, {"tokens": on_mesh(tokens[:, :prompt], mesh)})[0]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"prefill": read_launches()}
    with torch.no_grad(), dtensor_mode(model):
        cache = model.init_cache(B, prompt + steps)
        model.prefill(*_inputs(model, on_mesh(tokens[:, :prompt], mesh)), cache)
    reset_launches()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i in range(steps):
        logits.append(decode(model, cache, on_mesh(tokens[:, prompt + i], mesh),
                             np.full(B, prompt + i))[0])
    torch.cuda.synchronize()
    launches["decode"] = read_launches()
    del cache
    return ([whole(x) for x in logits], launches,
            {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t2})


def opt_train(model, m_shard, mesh, cfg, run, t_tok, t_tgt) -> tuple[dict, dict, float]:
    """One ``build_train_step`` step of ``model`` (parameters on ``mesh``,
    moments placed by ``m_shard``) on DTensor inputs: ({"loss", "grad_norm"}
    as floats, launches, host seconds)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw
    model.requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()), run, shardings=m_shard, mesh=mesh)
    train = build_train_step(cfg, run, mesh)
    batch = {"tokens": on_mesh(t_tok, mesh), "targets": on_mesh(t_tgt, mesh)}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt, metrics = train(model, opt, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    model.requires_grad_(False)
    del opt
    return ({k: float(whole(metrics[k])) for k in ("loss", "grad_norm")}, launches, seconds)


def opt_hold(runs: dict, mesh, run, tokens, t_tok, t_tgt) -> dict:
    """Every variant of ``runs`` ({name: config}, "base" first) against base
    in f32 on ``mesh``: the serving logits of ``opt_serve`` at the configs'
    depth, one ``build_train_step`` step's loss and gradient norm at
    OPT_F32_TRAIN_LAYERS, each variant's train step on fresh weights from
    the same seed. Raises past OPT_TOL (relative); returns {name: the
    errors and whether every bit is equal}."""
    from repro_torch.configs import replace
    m32, _ = opt_model(runs["base"], mesh, f32=True)
    logits = {}
    for name, cfg in runs.items():
        set_cfg(m32, cfg)
        logits[name] = opt_serve(m32, mesh, cfg, tokens, run)[0]
    del m32
    torch.cuda.empty_cache()
    terms = {}
    for name, cfg in runs.items():
        cfg = replace(cfg, num_layers=OPT_F32_TRAIN_LAYERS)
        m32, m_shard = opt_model(cfg, mesh, f32=True)
        terms[name] = opt_train(m32, m_shard, mesh, cfg, run, t_tok, t_tgt)[0]
        del m32, m_shard
        torch.cuda.empty_cache()
    held = {}
    for name in runs:
        if name == "base":
            continue
        errs = {"logits_rel_err": max(rel_err(r, g) for r, g in zip(logits["base"],
                                                                      logits[name]))}
        errs.update({f"{k}_rel_err": abs(terms[name][k] - v) / abs(v)
                     for k, v in terms["base"].items()})
        if not all(e < OPT_TOL for e in errs.values()):
            raise AssertionError(f"optimized {runs[name].name} {name}: f32 off base by "
                                 f"{errs} (held at {OPT_TOL})")
        held[name] = {**errs, "bits_equal": terms[name] == terms["base"] and all(
            torch.equal(r, g) for r, g in zip(logits["base"], logits[name]))}
    return held


def phase_optimized(smi: str) -> dict:
    """The reference's perf knobs (``repro_torch.configs.optimized``) on the card
    (module docstring, phase 23). Returns {"launches": {run: launches},
    "rows": the scan's rows at the knobs' chunks for the kernels line}."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.optimized import DEFAULT_ON
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import close_mesh, make_local_mesh
    mesh = make_local_mesh(1, 1)
    run = RunConfig(remat="none")
    launches, out_rows = {}, []
    B, prompt, steps = OPT_RUN
    try:
        for arch in (MOE_ARCH, MLA_ARCH):
            base = train_arch_cfg(arch)
            variants = opt_variants(base)
            runs = {name: cfg for name, (cfg, same) in variants.items() if same is None}
            gen = torch.Generator(device="cuda").manual_seed(0)
            tokens = torch.randint(0, base.vocab_size, (B, prompt + steps), generator=gen,
                                   device="cuda")
            data = SyntheticTokens(DataConfig(base.vocab_size, TRAIN_SEQ, B, seed=0))
            t_tok, t_tgt = train_inputs(base, data.batch_at(0))
            held = opt_hold(runs, mesh, run, tokens, t_tok, t_tgt)
            # the bf16 runs: prefill, decode steps and one train step a variant
            model, m_shard = opt_model(base, mesh, f32=False)
            for name, cfg in runs.items():
                set_cfg(model, cfg)
                with knob_paths() as ran:
                    logits, serve_launches, secs = opt_serve(model, mesh, cfg, tokens, run)
                    metrics, train_launches, secs["train_step_s"] = opt_train(
                        model, m_shard, mesh, cfg, run, t_tok, t_tgt)
                if ran != knob_runs_wanted(cfg, steps):
                    raise AssertionError(f"optimized {arch} {name}: the knobs' code ran {ran}, "
                                         f"want {knob_runs_wanted(cfg, steps)}")
                none = dict.fromkeys(LAUNCH_COUNTERS, 0)
                want = {"prefill": {**none, "flash_attention": cfg.num_layers},
                        "decode": {**none, "paged_attention": 0 if cfg.attention == "mla"
                                   else cfg.num_layers * steps}}
                if serve_launches != want or not all(torch.isfinite(x).all() for x in logits):
                    raise AssertionError(f"optimized {arch} {name}: serving launches "
                                         f"{serve_launches}, want {want}, or logits not finite")
                hold_train_launches(f"optimized {arch} {name}", train_launches, 1, 1, cfg)
                if not np.isfinite(metrics["loss"]):
                    raise AssertionError(f"optimized {arch} {name}: loss not finite")
                torch.cuda.empty_cache()
                launches[(arch, name)] = {"serve": serve_launches, "train": train_launches}
                also = [n for n, (_, same) in variants.items() if same == name]
                print(f"optimized {arch} ({cfg.num_layers} layers) {name}"
                      + (f" (= {', '.join(also)})" if also else "")
                      + f": prefill {secs['prefill_s']:.6f} s, {steps} decode steps "
                      f"{secs['decode_s']:.6f} s, train step {secs['train_step_s']:.6f} s "
                      f"(first: cuBLAS, allocator); launches {serve_launches} then "
                      f"{train_launches}; the knobs' code ran {ran}; f32 hold "
                      f"{held.get(name, 'base')} [{smi}]")
                emit({"phase": "optimized", "arch": arch, "variant": name, "also_for": also,
                      "layers": cfg.num_layers, "moe_shard_map": cfg.moe_shard_map,
                      "mla_latent_psum": cfg.mla_latent_psum, "default_on": sorted(DEFAULT_ON),
                      "batch": B, "prompt": prompt, "decode_steps": steps,
                      "train_seq": TRAIN_SEQ, **secs, "train_loss": metrics["loss"],
                      "serve_launches": serve_launches, "train_launches": train_launches,
                      "knob_code_ran": ran, "f32_hold": held.get(name),
                      "f32_train_layers": OPT_F32_TRAIN_LAYERS, "held_at": OPT_TOL,
                      "card": smi})
            del model, m_shard
            torch.cuda.empty_cache()
        out_rows = opt_scan(smi, mesh, run, launches)
    finally:
        close_mesh()
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": out_rows}


def opt_scan(smi: str, mesh, run, launches: dict) -> list:
    """mamba2-780m at full width under ``ssd_chunk`` (64) and ``ssd_chunk128``
    (128): a prefill of SSM_PROMPT tokens (B BATCH) and one train step (B
    TRAIN_BATCH, S TRAIN_SEQ) through the step builders, launches reset
    before and held after; then the scan's three kernels at those chunks
    against their plain versions, as rows of the kernels line."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.optimized import optimize
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import build_prefill_step, build_train_step
    from repro_torch.models import init_transformer
    from repro_torch.optim import adamw
    base = get_config(SSM_ARCH)
    model = init_transformer(base, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, base.vocab_size, (BATCH, SSM_PROMPT), generator=gen, device="cuda")
    data = SyntheticTokens(DataConfig(base.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    t_tok, t_tgt = train_inputs(base, data.batch_at(0))
    rows, L = [], base.num_layers
    for knob in ("ssd_chunk", "ssd_chunk128"):
        cfg = optimize(base, only={knob})
        set_cfg(model, cfg)
        prefill, _, _ = build_prefill_step(cfg, ShapeConfig("p", SSM_PROMPT, BATCH, "prefill"),
                                           run, mesh)
        reset_launches()
        with torch.no_grad():
            logits, _ = prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        serve_launches = read_launches()
        model.requires_grad_(True)
        opt = adamw.init(dict(model.named_parameters()), run)
        reset_launches()
        t0 = time.perf_counter()
        opt, metrics = build_train_step(cfg, run, mesh)(model, opt, {"tokens": t_tok,
                                                                      "targets": t_tgt})
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        train_launches = read_launches()
        model.requires_grad_(False)
        del opt
        want_serve = {"flash_attention": 0, "flash_attention_bwd": 0, "paged_attention": 0,
                      "ring_attention": 0, "latent_attention": 0,
                      "ssd_scan": L, "ssd_scan_bwd": 0, "adamw": 0}
        if serve_launches != want_serve or not torch.isfinite(logits).all():
            raise AssertionError(f"optimized {SSM_ARCH} {knob}: prefill launches "
                                 f"{serve_launches}, want {want_serve}, or logits not finite")
        hold_train_launches(f"optimized {SSM_ARCH} {knob}", train_launches, 1, 1, cfg)
        if not torch.isfinite(metrics["loss"]):
            raise AssertionError(f"optimized {SSM_ARCH} {knob}: loss not finite")
        launches[(SSM_ARCH, knob)] = {"serve": serve_launches, "train": train_launches}
        torch.cuda.empty_cache()
        K, m = cfg.ssm_chunk, cfg
        serving = ssd_serving_shape()[:5] + (K,)
        x, Bm, Cm, dt, A = ssd_inputs(torch.device("cuda"), gen, *serving[:5], model_like=True)
        y, h = ssd.ssd_scan_op(x, Bm, Cm, dt, A, chunk=K, return_state=True)
        y_plain, h_plain = ssd_chunked(x, Bm, Cm, dt, A, chunk=K)
        err = max(max_err(y, y_plain, SSD_SERVING_TOL, f"optimized scan chunk {K} y"),
                  max_err(h, h_plain, SSD_SERVING_TOL, f"optimized scan chunk {K} h_final"))
        del x, Bm, Cm, dt, A, y, h, y_plain, h_plain
        train_shape = (TRAIN_BATCH, TRAIN_SEQ, m.ssm_heads, m.ssm_head_dim, m.ssm_state, K)
        rows += [
            scan_row(torch.device("cuda"), gen, serving, serve_launches["ssd_scan"], err,
                     f"{knob}: {SSM_ARCH} prefill at chunk {K}"),
            scan_row(torch.device("cuda"), gen, train_shape, train_launches["ssd_scan"], None,
                     f"{knob}: {SSM_ARCH} training forward at chunk {K}", training=True),
            scan_bwd_row(torch.device("cuda"), gen, train_shape, train_launches["ssd_scan_bwd"],
                         f"{knob}: {SSM_ARCH} backward at chunk {K}")]
        print(f"optimized {SSM_ARCH} {knob} (chunk {K}): prefill launches {serve_launches}, "
              f"train step {step_s:.6f} s (first), launches {train_launches}; kernels "
              + ", ".join(f"{r['name']} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f})"
                          for r in rows[-3:]) + f" [{smi}]")
        emit({"phase": "optimized", "arch": SSM_ARCH, "variant": knob, "chunk": K,
              "prefill_launches": serve_launches, "train_launches": train_launches,
              "train_step_s": step_s, "serving_scan_err": err,
              "held_at": {"serving": SSD_SERVING_TOL, "training": SSD_TOL,
                          "backward": SSD_BWD_TOL}, "card": smi})
        del logits, metrics
    del model
    torch.cuda.empty_cache()
    return rows


MOE_TRAIN = (2, 4096)        # deepseek-v2-lite-5l.train's batch and sequence


def phase_moe_train() -> None:
    """Phase 24 (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.moe import MoE, moe_apply
    cfg = get_config("deepseek-v2-lite-5l")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = MOE_TRAIN
    try:                         # held at the end, after the layer's checks
        row, fault = flash_bwd_row(dev, gen, B, S, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.num_layers,
                                   "deepseek-v2-lite-5l.train's shape"), None
    except AssertionError as e:
        row, fault = None, str(e)
    p = MoE(cfg, device=dev)
    with torch.no_grad():
        for t in p.parameters():
            fan_in = t.shape[-2] if t.ndim == 3 else t.shape[0]
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * fan_in ** -0.5)
    p.requires_grad_(True)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).bfloat16().requires_grad_()
    dy = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)

    def fwd_bwd() -> list:
        x.grad = None
        p.zero_grad(set_to_none=True)
        y, aux = moe_apply(p, x, cfg)
        ((y.float() * dy).sum() + aux).backward()
        return [y.detach(), aux.detach(), x.grad] + [t.grad for t in p.parameters()]

    first = fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = fwd_bwd()
        torch.cuda.synchronize()
    kernels = [(ev.name(), ev.duration_ns() * 1e-6) for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation()]
    grouped = [(n, ms) for n, ms in kernels if "GroupProblemShape" in n]
    alike = sorted({n[:160] for n, _ in kernels if "GroupProblemShape" not in n
                    and ("cutlass" in n.lower() or "group" in n.lower())})
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    T, K, M, Fe, E = B * S, cfg.top_k, cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    bound = sum(bound_ms(nbytes, 2.0 * T * K * M * Fe, torch.bfloat16)[0] for nbytes in
                [(T * K * (M + Fe) + E * M * Fe) * 2] * 9)
    emit({"phase": "moe_train", "flash_bwd_row": row, "grouped_kernels": len(grouped),
          "grouped_ms": sum(ms for _, ms in grouped), "grouped_bound_ms": bound,
          "grouped_names": sorted({n[:160] for n, _ in grouped}), "alike_names": alike,
          "layer_kernels": len(kernels), "layer_device_ms": sum(ms for _, ms in kernels),
          "repeat_equal": equal, "flash_bwd_fault": fault})
    if len(grouped) != 9 or not equal or fault:
        raise AssertionError(f"moe_train: {len(grouped)} grouped kernels (9 wanted), "
                             f"repeat equal {equal}, flash backward {fault}")
    del p, x, dy, first, again
    torch.cuda.empty_cache()


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds printed and kept for the summary line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_SECONDS[name]:.3f} s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    timed("model", phase_model)
    timed("examples", phase_examples)
    torch.cuda.empty_cache()
    main_err = timed("kernels_vs_plain", phase_compare, dev)
    latent = timed("latent", phase_latent, dev)
    timed("latent_served", phase_latent_served)
    torch.cuda.empty_cache()
    served = timed("serve", phase_serve, dev)
    launches = served["launches"]
    del served                                    # free qwen's weights and pool
    torch.cuda.empty_cache()
    served = timed("serve_ssm", phase_serve_ssm)
    timed("ssm_f32", phase_ssm_f32, served["model"], served["prompts"], served["fed"])
    launches["ssd_scan"] = served["launches"]["ssd_scan"]
    del served
    torch.cuda.empty_cache()
    timed("serve_spill", phase_serve_spill)
    torch.cuda.empty_cache()
    kv_spill_launches = timed("kv_spill", phase_kv_spill, dev)
    torch.cuda.empty_cache()
    arch_launches = timed("serve_archs", phase_serve_archs, smi)
    timed("dense_decode", phase_dense_decode)
    timed("hybrid_decode", phase_hybrid_decode)
    timed("mla_decode", phase_mla_decode)
    train_launches = timed("train", phase_train)
    ssm_train_launches = timed("train_ssm", phase_train_ssm)
    arch_train_launches = timed("train_archs", phase_train_archs, smi)
    grads_launches = timed("train_grads", phase_train_grads, smi)
    timed("moe_repeat", phase_moe_repeat)
    timed("moe_train", phase_moe_train)
    timed("train_resume", phase_train_resume)
    timed("steps", phase_steps, smi)
    opt = timed("optimized", phase_optimized, smi)
    latent["launches"] = arch_launches[MLA_ARCH]["latent_attention"]
    timed("kernels", phase_kernels, dev, main_err, launches, kv_spill_launches,
          arch_launches, train_launches, grads_launches, ssm_train_launches,
          arch_train_launches, [latent, *opt["rows"]])
    emit({"phase_seconds": PHASE_SECONDS, "total_s": time.perf_counter() - t_start})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
