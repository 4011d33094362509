"""The yardstick: an H100's published peaks, and the operations and minimum
bytes of each kernel and of each whole step, from shapes alone.

Peaks are NVIDIA's H100 SXM data sheet's dense rates at the 700 W limit.
Work is counted as the inputs need it: paged attention over live tokens
only, windowed attention over the (query, key) pairs inside the window.
Bytes count each input read once and each output written once. A share
is the least time (the larger of operations over peak and bytes over
bandwidth) over the measured time, so no implementation can pass 100 %.
The kernel counts are copied from the port's ``chip_smoke.py`` (its
``bound_ms``, ``ssd_work``, ``ssd_bwd_work`` and byte counts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PEAK_BF16 = 989e12     # FLOP/s, bf16 and fp16 tensor cores, dense
PEAK_TF32 = 495e12     # FLOP/s, the highest rate float32 work could run at (TF32)
HBM_BW = 3.35e12       # bytes/s
BF16, F32 = 2, 4       # bytes an element

Work = Tuple[float, float, float]     # (bf16 flops, f32 flops, bytes)


def least_s(work: Work) -> float:
    """The least seconds the card could take: operations at their peaks, or bytes."""
    bf16, f32, nbytes = work
    return max(bf16 / PEAK_BF16 + f32 / PEAK_TF32, nbytes / HBM_BW)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def attended_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs scored: query i sits at position i + Skv − Sq and
    sees keys up to it (causal) and, with a window, the last ``window`` of them."""
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_fwd(B: int, S: int, H: int, Kh: int, D: int, window: Optional[int],
              lse: bool = False) -> Work:
    """Causal self-attention forward, bf16: QKᵀ and PV, 2·D flops each a scored
    pair; q, k, v read, out written (and the f32 LSE with ``lse``)."""
    flops = 4 * D * B * H * attended_pairs(S, S, True, window)
    nbytes = (2 * B * S * H * D + 2 * B * S * Kh * D) * BF16 + lse * B * H * S * F32
    return flops, 0.0, nbytes


def flash_bwd(B: int, S: int, H: int, Kh: int, D: int, window: Optional[int]) -> Work:
    """Its backward, bf16: 2.5 forwards' flops (QKᵀ again, dV, dP, dQ, dK);
    q, o, do, dq and k, v, dk, dv once each, the LSE and Δ (f32)."""
    flops = 4 * D * B * H * attended_pairs(S, S, True, window) * 5 // 2
    nbytes = (4 * B * S * H * D + 4 * B * S * Kh * D) * BF16 + 2 * B * H * S * F32
    return flops, 0.0, nbytes


def paged_decode(live_tokens: int, B: int, H: int, Kh: int, D: int, blocks: int = 0
                 ) -> Work:
    """One paged decode call over ``live_tokens`` cached tokens in all (the
    sum of the sequences' lengths), bf16: q·K and P·V, 2·D flops each a query
    head and token; q read, out written, each live token's K and V read once,
    and ``blocks`` int32 descriptors (start, count) plus the B lengths."""
    flops = 4 * D * H * live_tokens
    nbytes = (2 * B * H * D + live_tokens * 2 * Kh * D) * BF16 + (2 * blocks + B) * 4
    return flops, 0.0, nbytes


def ssd_fwd(B: int, L: int, H: int, P: int, N: int, K: int, states: bool = False) -> Work:
    """One SSD scan, f32, final state written (and with ``states`` the state
    entering each chunk). Per (b, chunk) C·Bᵀ over the causal half once; per
    (b, h, chunk) the masked scores times x, C·h_prev and the state update;
    2 flops a multiply-add; elementwise work left out."""
    n_chunks, tri = L // K, K * (K + 1) // 2
    flops = 2 * B * n_chunks * (N * tri + H * (P * tri + 2 * K * N * P))
    nbytes = F32 * (2 * B * L * H * P + 2 * B * L * N + B * L * H + H + B * H * N * P
                    + states * B * n_chunks * H * N * P)
    return 0.0, flops, nbytes


def ssd_bwd(B: int, L: int, H: int, P: int, N: int, K: int) -> Work:
    """The scan's backward with no h_final cotangent, f32: per (b, chunk) C·Bᵀ
    and dGₛ·B, dGₛᵀ·C over the causal half (dG summed over heads first); per
    (b, h, chunk) dW and Wᵀ·dy over the causal half, five K·N·P products, u
    and the inbound dcs term. Bytes: x, dy, Bm, Cm, dt, A and the chunk-entry
    states read, dx, dB, dC, ddt, dA written."""
    n_chunks, tri = L // K, K * (K + 1) // 2
    flops = 2 * B * n_chunks * (3 * N * tri + H * (2 * P * tri + 5 * K * N * P + 2 * K * P))
    nbytes = F32 * (3 * B * L * H * P + 4 * B * L * N + 2 * B * L * H + 2 * H
                    + B * n_chunks * H * N * P)
    return 0.0, flops, nbytes


# ---------------------------------------------------------------------------
# whole steps, from the configuration's sizes (m: the config file's "model")
# ---------------------------------------------------------------------------

def _vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def block_params(m: dict) -> int:
    """Matrix parameters of one block (the products a token goes through)."""
    M = m["d_model"]
    n = 0
    if m.get("mixer", "attn") in ("attn", "hybrid"):
        H, Kh, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        n += M * (H * D + 2 * Kh * D) + H * D * M
    if m.get("mixer", "attn") in ("ssm", "hybrid"):
        Din, N = m["ssm_heads"] * m["ssm_head_dim"], m["ssm_state"]
        n += M * (2 * Din + 2 * N + m["ssm_heads"]) + Din * M
    return n + 3 * M * m.get("d_ff", 0)


def weight_bytes(m: dict) -> int:
    """Every parameter a step reads, bf16: the blocks' matrices and vectors, the
    head; not the embedding table, of which a step reads only its tokens' rows."""
    M = m["d_model"]
    vec = 2 * M
    if m.get("mixer", "attn") in ("ssm", "hybrid"):
        Din, N = m["ssm_heads"] * m["ssm_head_dim"], m["ssm_state"]
        vec += 5 * (Din + 2 * N) + 3 * m["ssm_heads"] + Din      # conv w, b; A, D, dt; norm
    return BF16 * (m["num_layers"] * (block_params(m) + vec) + M * _vocab(m) + M)


def params_total(m: dict) -> int:
    """Every parameter, the embedding table included (once, where the head is
    tied to it)."""
    table = 0 if m.get("tie_embeddings") else _vocab(m) * m["d_model"]
    return weight_bytes(m) // BF16 + table


def decode_step(m: dict, lengths) -> Work:
    """One decode step of len(lengths) sequences, each attending over its
    length (tokens cached, this one included): the products of every block
    and the head, attention over live tokens (a window caps them), the SSM's
    state update; bytes: the weights once, the embedding rows, each live
    token's K and V, the SSM state read and written, the logits written."""
    B = len(lengths)
    M, L = m["d_model"], m["num_layers"]
    bf16 = 2 * B * (L * block_params(m) + M * _vocab(m))
    f32 = 0.0
    nbytes = weight_bytes(m) + B * M * BF16 + B * _vocab(m) * BF16
    if m.get("mixer", "attn") in ("attn", "hybrid"):
        H, Kh, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        live = int(sum(min(n, m["window"]) if m.get("window") else n for n in lengths))
        bf16 += L * 4 * D * H * live
        nbytes += L * live * 2 * Kh * D * BF16
    if m.get("mixer", "attn") in ("ssm", "hybrid"):
        Hs, P, N = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
        f32 += L * B * Hs * 6 * N * P
        nbytes += L * B * 2 * Hs * N * P * F32
    return bf16, f32, nbytes


def forward_flops(m: dict, B: int, S: int) -> Tuple[float, float]:
    """(bf16, f32) flops of a forward over (B, S) tokens: the blocks' products,
    attention over the pairs in the window, the SSM scan; the head at every
    position (``head_rows`` = S) is added by the caller."""
    L = m["num_layers"]
    bf16 = 2.0 * B * S * L * block_params(m)
    f32 = 0.0
    if m.get("mixer", "attn") in ("attn", "hybrid"):
        bf16 += L * flash_fwd(B, S, m["num_heads"], m["num_kv_heads"], m["head_dim"],
                              m.get("window"))[0]
    if m.get("mixer", "attn") in ("ssm", "hybrid"):
        f32 += L * ssd_fwd(B, S, m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"],
                           min(m["ssm_chunk"], S))[1]
    return bf16, f32


def prefill(m: dict, S: int) -> Work:
    """A prefill of one prompt of S tokens with last-position logits: the
    forward's flops and the head's on one row; bytes: the weights once, the
    prompt's K/V written to the cache (attention archs)."""
    bf16, f32 = forward_flops(m, 1, S)
    bf16 += 2.0 * m["d_model"] * _vocab(m)
    nbytes = weight_bytes(m)
    if m.get("mixer", "attn") in ("attn", "hybrid"):
        nbytes += m["num_layers"] * S * 2 * m["num_kv_heads"] * m["head_dim"] * BF16
    return bf16, f32, nbytes


def train_step(m: dict, B: int, S: int) -> Work:
    """One training step: forward and backward (three forwards' products,
    attention's backward 2.5 forwards, the scan's backward as counted above),
    the head at every position; bytes: the bf16 parameters read and written,
    their bf16 gradients written and read, AdamW's two f32 moments read and
    written."""
    head = 2.0 * B * S * m["d_model"] * _vocab(m)
    L = m["num_layers"]
    bf16_total = 3 * (2.0 * B * S * L * block_params(m)) + 3 * head
    f32_total = 0.0
    if m.get("mixer", "attn") in ("attn", "hybrid"):
        a = (m["num_heads"], m["num_kv_heads"], m["head_dim"], m.get("window"))
        bf16_total += L * (flash_fwd(B, S, *a)[0] + flash_bwd(B, S, *a)[0])
    if m.get("mixer", "attn") in ("ssm", "hybrid"):
        s = (m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], min(m["ssm_chunk"], S))
        f32_total += L * (ssd_fwd(B, S, *s, states=True)[1] + ssd_bwd(B, S, *s)[1])
    n = params_total(m)
    return bf16_total, f32_total, n * (2 * BF16 + 2 * BF16 + 4 * F32)
