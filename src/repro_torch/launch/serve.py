"""Batched serving: prefill → greedy decode over the model's decode cache.

The port of ``repro/launch/serve.py``, for every arch of the registry.
Prefill runs every attention layer through the flash-attention kernel and
every SSM layer through the SSD chunk-scan kernel, and writes each layer's
decode state into the model's cache (``Transformer.init_cache``): K/V into
device pages for a dense, MoE or frontend GQA arch, whose cache plans its
page-run blocks once, when it is made, and whose decode steps run every
layer through the paged-attention kernel; the last ``window`` tokens' K/V
into a ring (hymba, decoded through the ring-attention kernel); MLA's latent
(deepseek, absorbed decode); the (conv, h) state for the SSM (mamba2, and
hymba's SSM half: an O(1) recurrent update). Archs with a stubbed modality
frontend (musicgen, llava) take embedding prompts and decode inputs drawn
from the seeded generator, as in the reference, and have no greedy
continuation. Weights come from a seeded init, so nothing is downloaded.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --reduced --device cpu

``--device cpu`` runs the plain PyTorch versions of the kernels instead.

Without ``--spill`` it then prints each part of the decode cache's
``snapshot()``: the bytes it holds on the device, and for the paged pool
the tokens, bytes and block descriptors that the last step found live, to
size the pool, the ring or the SSM state against what the sequences use. A
paged decode prints the page table's page-run coalescing before it. Then
the decode steps' counts (``Transformer.decode_graphs``): on the card the
steps replayed as CUDA graphs and the graphs captured by launch key, and
the steps run eagerly by reason (the first warms the capture stream; on the
CPU every step is eager). A MoE arch then prints each MoE layer's routing
counter (``Transformer.routing_snapshot``): the pairs routed in the prefill
and the decode, the most and the mean an expert took, and the pairs dropped.

``--spill`` adds the reference's remote-KV tier: a ``kv_store`` of
``box.open(spec, device=--device)`` (its pool on the device, donor memory
pinned on the host) takes one row of KV features per sequence and decode
step, then spills sequence 0 to the donors and fetches it back over the
simulated fabric, while ``--clients`` − 1 background pagers contend for
the same donors. The fabric flags (``--donors``, ``--clients``,
``--replication``, ``--link-*``, ``--straggler``) only take effect with it.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --spill --donors 3 --replication 2 --clients 2
"""

from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import box, resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.paged_attention.ops import descriptor_stats
from repro_torch.models import (Cache, HybridCache, PagedKVPool, Transformer,
                                init_transformer)

PAGES_PER_BLOCK = 4
# pages reserved per client for the KV spill arena (the heap slice of
# each donor region); the rest of the slice backs background paging
KV_HEAP_PAGES = 1024
KV_FEATURES = 64
BG_PAGES = 64


@dataclass
class SpillResult:
    kv: box.KVStore                # the kv_store, sequence 0 fetched back
    table: np.ndarray              # its page table before the spill
    seq0_before: torch.Tensor      # sequence 0's gather before the spill
    stats: Dict                    # the session's stats tree after the fetch
    bg_rates: Dict[int, float]     # background client → pages/s


@dataclass
class ServeResult:
    model: Transformer
    cache: Cache
    prompts: torch.Tensor          # (B, prompt_len), or (B, prompt_len, M) embeddings
    fed: torch.Tensor              # (B, gen[, M]): what each decode step took
    decode_logits: torch.Tensor    # (B, gen, padded_vocab)
    generated: Optional[np.ndarray]  # (B, gen) greedy continuation; None for embeddings
    prefill_s: float               # host clock, ends in a device sync
    decode_s: float
    spill: Optional[SpillResult] = None


def _embeddings(rng: np.random.Generator, shape, device: torch.device) -> torch.Tensor:
    """Standard-normal stand-ins for a stubbed frontend's embeddings, bf16."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, torch.bfloat16)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _snapshots(cache: Cache) -> Dict[str, Dict[str, int]]:
    """Each part of a decode cache's ``snapshot()``, by the part's class."""
    parts = (cache.kv, cache.ssm) if isinstance(cache, HybridCache) else (cache,)
    return {type(part).__name__: part.snapshot() for part in parts}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--spill", action="store_true",
                    help="spill finished sequences' KV to remote memory")
    # fabric topology + degraded-mode scenario surface
    ap.add_argument("--donors", type=int, default=2,
                    help="donor nodes in the remote-memory fabric")
    ap.add_argument("--clients", type=int, default=1,
                    help="client endpoints sharing the donor fabric; "
                         "extra clients run a background paging workload "
                         "contending with the serving client")
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--link-latency-us", type=float, default=1.0,
                    help="per-link propagation delay (virtual us)")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="per-link bandwidth cap (default: NIC port only)")
    ap.add_argument("--straggler", type=str, default=None, metavar="NODE:X",
                    help="make donor NODE a straggler with latency xX")
    return ap


def _fabric_faults(ap: argparse.ArgumentParser, args) -> Optional[list]:
    """The reference's rule: fabric flags only take effect with --spill;
    ``--straggler NODE:X`` becomes one slow-donor fault."""
    fabric_flags = (args.straggler is not None or args.link_gbps is not None
                    or args.link_latency_us != 1.0 or args.donors != 2
                    or args.replication != 2 or args.clients != 1)
    if fabric_flags and not args.spill:
        ap.error("fabric flags (--donors/--clients/--replication/--link-*/"
                 "--straggler) only take effect with --spill")
    if not args.straggler:
        return None
    try:
        node, factor = args.straggler.split(":")
        return [{"kind": "slow", "node": int(node), "factor": float(factor)}]
    except ValueError:
        ap.error(f"--straggler expects NODE:FACTOR (e.g. 1:30), "
                 f"got {args.straggler!r}")


def _open_kv_store(args, faults, device: torch.device):
    spec = box.ClusterSpec(
        num_donors=args.donors, donor_pages=1 << 14,
        replication=args.replication,
        num_clients=args.clients,
        heap_pages=min(KV_HEAP_PAGES, (1 << 14) // args.clients // 2),
        link={"latency_us": args.link_latency_us, "gbps": args.link_gbps},
        faults=faults)
    session = box.open(spec, device=device)
    kv = session.kv_store(num_pages=256, page_tokens=args.page_tokens,
                          kv_features=KV_FEATURES)
    for b in range(args.batch):
        kv.add_sequence(b)
    return session, kv


def _spill_and_fetch(session, kv, clients: int,
                     device: torch.device) -> SpillResult:
    """Spill sequence 0 to the donors and fetch it back while the extra
    clients page to the same donors — the reference's multi-client
    scenario — and print the reference's lines."""
    B = len(kv.tables)
    Pmax = max(len(v) for v in kv.tables.values())
    table = -np.ones((B, Pmax), np.int32)
    for b in range(B):
        table[b, : len(kv.tables[b])] = kv.tables[b]
    print("page-run coalescing:", descriptor_stats(table, PAGES_PER_BLOCK))
    bg_rates: Dict[int, float] = {}

    def bg_pager(idx: int) -> None:
        pager = session.pager(idx)
        # per-thread generator: np.random.Generator is not thread-safe
        r = np.random.default_rng(idx)
        buf = torch.from_numpy(r.integers(0, 255, 4096).astype(np.uint8)).to(device)
        t0 = time.perf_counter()
        for pid in range(BG_PAGES):
            pager.swap_out(pid, buf, wait=True)
        bg_rates[idx] = BG_PAGES / (time.perf_counter() - t0)

    threads = [threading.Thread(target=bg_pager, args=(i,))
               for i in range(1, clients)]
    for t in threads:
        t.start()
    seq0_before = kv.gather(0).clone()
    kv.spill(0)
    kv.fetch(0)
    for t in threads:
        t.join()
    if len(bg_rates) != len(threads):
        raise RuntimeError("a background client failed (see its traceback)")
    st = session.stats()
    serving_nic = st["nic"][str(session.clients[0])]
    merge = st["client"]["0"]["box"]["merge"]
    print(f"spill/fetch: {serving_nic['rdma_ops']} RDMA ops, "
          f"merge drains {merge['drains']}")
    if bg_rates:
        print("background clients (pages/s under contention):",
              {session.clients[i]: f"{r:,.0f}" for i, r in sorted(bg_rates.items())})
        print("donor-side per-client service:", st["fabric"]["service"])
    return SpillResult(kv, table, seq0_before, st, bg_rates)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = _parser()
    args = ap.parse_args(argv)
    faults = _fabric_faults(ap, args)
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
    if cfg.frontend:
        prompts = _embeddings(rng, (B, args.prompt_len, cfg.d_model), device)
    else:
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, args.prompt_len))).to(device)
    cache = model.init_cache(B, S, page_tokens=args.page_tokens,
                             pages_per_block=PAGES_PER_BLOCK)
    session = kv = None
    if args.spill:
        session, kv = _open_kv_store(args, faults, device)

    _sync(device)
    t0 = time.perf_counter()
    logits = model.prefill(prompts, cache)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.prompt_len} tokens × {B} seqs in {prefill_s:.6f}s")

    # a frontend arch decodes one drawn embedding a sequence, every step, as
    # the reference does; a token arch its greedy continuation
    if cfg.frontend:
        tok = _embeddings(rng, (B, cfg.d_model), device)
    else:
        tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
    cur = np.full(B, args.prompt_len, np.int64)
    fed, step_logits = [], []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        fed.append(tok)
        logits = model.decode_step(cache, tok, cur)
        step_logits.append(logits)
        if not cfg.frontend:
            tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
        cur += 1
        if kv is not None:
            kv_rows = torch.from_numpy(
                rng.normal(size=(B, KV_FEATURES)).astype(np.float32))
            if device.type == "cuda":   # from pinned memory: no host sync
                kv_rows = kv_rows.pin_memory().to(device, non_blocking=True)
            for b in range(B):
                kv.append_tokens(b, kv_rows[b : b + 1])
    _sync(device)
    decode_s = time.perf_counter() - t0
    print(f"decode {args.gen} steps × {B} seqs: "
          f"{args.gen * B / decode_s:,.1f} tok/s")

    fed_t = torch.stack(fed, dim=1)
    generated = None
    if not cfg.frontend:
        generated = torch.cat([fed_t[:, 1:], tok[:, None]], dim=1).cpu().numpy()
        print("sample continuation token ids:", generated[0, :16].tolist())
    spill = None
    if kv is not None:
        try:
            spill = _spill_and_fetch(session, kv, args.clients, device)
        finally:
            session.close()
    else:
        if isinstance(cache, PagedKVPool):
            print("page-run coalescing:",
                  descriptor_stats(cache.page_table, PAGES_PER_BLOCK))
        print("decode cache after the last step:", _snapshots(cache))
        print("decode steps:", model.decode_graphs(cache).snapshot())
        if cfg.uses_moe:
            print("routing (prefill and decode):", model.routing_snapshot())
    print("SERVING DONE")
    return ServeResult(model, cache, prompts, fed_t,
                       torch.stack(step_logits, dim=1), generated, prefill_s,
                       decode_s, spill)


if __name__ == "__main__":
    main()
