"""Batched serving: prefill → greedy decode over the model's decode cache.

The port of ``repro/launch/serve.py``. For a dense-GQA arch, prefill runs
every layer through the flash-attention kernel and writes its K/V into
device pages; each decode step plans the page-run blocks once on the host
and runs every layer through the paged-attention kernel. For an SSM arch
(mamba2-780m), prefill runs every layer through the SSD chunk-scan kernel
and keeps each layer's final (conv, h) state; decode is the O(1)
recurrent update. Weights come from a seeded init, so nothing is
downloaded.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 256

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
The remote-KV tier (``--spill``) and the fabric flags need the RDMAbox
engine, which is not ported yet (ROADMAP item 8); they are refused.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.paged_attention.ops import descriptor_stats
from repro_torch.models import PagedKVPool, SSMCache, Transformer, init_transformer

PAGES_PER_BLOCK = 4
ENGINE_FLAGS = ("spill", "donors", "clients", "replication", "link_latency_us",
                "link_gbps", "straggler")


@dataclass
class ServeResult:
    model: Transformer
    cache: Union[PagedKVPool, SSMCache]
    prompts: torch.Tensor          # (B, prompt_len)
    fed: torch.Tensor              # (B, gen): the token each decode step took
    decode_logits: torch.Tensor    # (B, gen, padded_vocab)
    generated: np.ndarray          # (B, gen) greedy continuation
    prefill_s: float               # host clock, ends in a device sync
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the reference's remote-KV and fabric surface: refused until ported
    ap.add_argument("--spill", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--donors", "--clients", "--replication", "--link-latency-us",
                 "--link-gbps", "--straggler"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    return ap


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = _parser()
    args = ap.parse_args(argv)
    given = [f"--{f.replace('_', '-')}" for f in ENGINE_FLAGS
             if getattr(args, f) not in (None, False)]
    if given:
        ap.error(f"{' '.join(given)}: the remote-KV tier and its fabric need "
                 "the RDMAbox engine, which repro_torch has not ported yet "
                 "(ROADMAP item 8)")
    if args.gen < 1:
        ap.error("--gen must be at least 1")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if (cfg.uses_ssm and args.prompt_len > cfg.ssm_chunk
            and args.prompt_len % cfg.ssm_chunk):
        ap.error("seq_len must be a multiple of ssm_chunk "
                 f"(--prompt-len {args.prompt_len}, ssm_chunk {cfg.ssm_chunk})")
    device = resolve_device(args.device)
    B, S = args.batch, args.prompt_len + args.gen
    rng = np.random.default_rng(0)

    model = init_transformer(cfg, seed=0, device=device)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, args.prompt_len))).to(device)
    cache = model.init_cache(B, S, page_tokens=args.page_tokens,
                             pages_per_block=PAGES_PER_BLOCK)

    _sync(device)
    t0 = time.perf_counter()
    logits = model.prefill(prompts, cache)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.prompt_len} tokens × {B} seqs in {prefill_s:.6f}s")

    tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
    cur = np.full(B, args.prompt_len, np.int64)
    fed, step_logits = [], []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        fed.append(tok)
        logits = model.decode_step(cache, tok, cur)
        step_logits.append(logits)
        tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
        cur += 1
    _sync(device)
    decode_s = time.perf_counter() - t0
    print(f"decode {args.gen} steps × {B} seqs: "
          f"{args.gen * B / decode_s:,.1f} tok/s")

    fed_t = torch.stack(fed, dim=1)
    generated = torch.cat([fed_t[:, 1:], tok[:, None]], dim=1).cpu().numpy()
    print("sample continuation token ids:", generated[0, :16].tolist())
    if isinstance(cache, PagedKVPool):
        print("page-run coalescing:",
              descriptor_stats(cache.page_table, PAGES_PER_BLOCK))
    print("SERVING DONE")
    return ServeResult(model, cache, prompts, fed_t,
                       torch.stack(step_logits, dim=1), generated, prefill_s,
                       decode_s)


if __name__ == "__main__":
    main()
