"""The yardstick for a DeepSeek-V2 decoder's training step
(``bench/reference/mla_moe_train.py``'s model: MLA on every layer, a dense
SwiGLU on the first ``first_dense_layers`` layers, a dropless mixture of
experts after): the operations and least bytes of a step and of its grouped
expert products, from shapes alone, against ``bench.lib.roofline``'s H100
peaks (``least_s``).

Operations are 2 a multiply-add. A step's products are three forwards' of
the parameters a token goes through, at every position (the head's
included): MLA's five projections, the dense SwiGLU, the router (float32, as
the program keeps it, counted at the TF32 peak), the ``top_k`` routed
experts of ``num_experts`` and the shared ones. Causal attention is counted
at what MLA needs, a scored pair each (query, key ≤ query): forward q·k at
qk_nope + qk_rope and p·v at v_head_dim; backward q·k again, dV and dP at
v_head_dim, dQ and dK at qk_nope + qk_rope. The least bytes of a step are
its parameters read and written in bf16, their bf16 gradients written and
read, and AdamW's two f32 moments read and written (the router in f32 is
counted at bf16's 2 bytes: 0.01 % of the parameters).

The grouped expert products (``expert_products``) are the nine of each MoE
layer that ``torch._grouped_mm`` runs, each over T·K rows (T tokens, K
experts a token): forward h = x·W_i, g = x·W_g, out = a·W_o; backward the
input gradients d(out)·W_oᵀ, dh·W_iᵀ, dg·W_gᵀ and the weight gradients
aᵀ·d(out), xᵀ·dh, xᵀ·dg. Each reads its two operands once and writes its
result once, in bf16; each is counted apart (``least_s`` a product, summed).
"""

from __future__ import annotations

from typing import List

from bench.lib.roofline import BF16, F32, Work, attended_pairs, least_s


def _vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def _moe_layers(m: dict) -> int:
    return m["num_layers"] - m.get("first_dense_layers", 0)


def mla_params(m: dict) -> int:
    """Matrix parameters of one layer's MLA: W_q, W_kv_a, W_kb, W_vb, W_o."""
    M, H = m["d_model"], m["num_heads"]
    R, dr, dn, dv = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    return M * H * (dn + dr) + M * (R + dr) + R * H * (dn + dv) + H * dv * M


def params_total(m: dict) -> int:
    """Every parameter of the model: embedding, blocks (norms included), head."""
    M, V, L = m["d_model"], _vocab(m), m["num_layers"]
    E, Fe, R = m["num_experts"], m["moe_d_ff"], m["kv_lora_rank"]
    Fs = m.get("num_shared_experts", 0) * Fe
    dense_l, moe_l = L - _moe_layers(m), _moe_layers(m)
    per_layer = mla_params(m) + 2 * M + R
    return (2 * V * M + M + L * per_layer + dense_l * 3 * M * m["d_ff"]
            + moe_l * (M * E + E * 3 * M * Fe + 3 * M * Fs))


def active_params(m: dict) -> tuple:
    """(bf16, f32) matrix parameters a token goes through: every layer's MLA,
    the dense layers' SwiGLU, the K routed and the shared experts, the head;
    the routers (f32) apart."""
    M, V, L = m["d_model"], _vocab(m), m["num_layers"]
    K, Fe = m["top_k"], m["moe_d_ff"]
    Fs = m.get("num_shared_experts", 0) * Fe
    dense_l, moe_l = L - _moe_layers(m), _moe_layers(m)
    bf16 = (L * mla_params(m) + dense_l * 3 * M * m["d_ff"]
            + moe_l * (K * 3 * M * Fe + 3 * M * Fs) + M * V)
    return bf16, moe_l * M * m["num_experts"]


def attention_flops(m: dict, B: int, S: int) -> float:
    """Causal MLA attention's forward and backward, one layer."""
    qk, dv = m["qk_nope_dim"] + m["qk_rope_dim"], m["v_head_dim"]
    pairs = B * m["num_heads"] * attended_pairs(S, S, True, None)
    return 2.0 * pairs * ((qk + dv) + (3 * qk + 2 * dv))


def train_step(m: dict, B: int, S: int) -> Work:
    """One training step over B sequences of S tokens: (bf16 flops, f32 flops,
    least bytes)."""
    bf16_p, f32_p = active_params(m)
    T = B * S
    bf16 = 3 * 2.0 * T * bf16_p + m["num_layers"] * attention_flops(m, B, S)
    f32 = 3 * 2.0 * T * f32_p
    return bf16, f32, params_total(m) * (2 * BF16 + 2 * BF16 + 4 * F32)


def expert_products(m: dict, B: int, S: int) -> List[Work]:
    """The nine grouped products of every MoE layer in one step, one Work each."""
    M, Fe = m["d_model"], m["moe_d_ff"]
    rows = B * S * m["top_k"]
    W = m["num_experts"] * M * Fe                      # one expert matrix, every expert
    flops = 2.0 * rows * M * Fe
    by_rows = (rows * M + W + rows * Fe) * BF16        # rows of M and a weight in, F out
    by_cols = (rows * Fe + W + rows * M) * BF16        # rows of F and a weight in, M out
    by_wgrad = (rows * M + rows * Fe + W) * BF16       # two row blocks in, a weight out
    one_layer = [(flops, 0.0, by_rows), (flops, 0.0, by_rows), (flops, 0.0, by_cols),
                 (flops, 0.0, by_rows), (flops, 0.0, by_cols), (flops, 0.0, by_cols),
                 (flops, 0.0, by_wgrad), (flops, 0.0, by_wgrad), (flops, 0.0, by_wgrad)]
    return one_layer * _moe_layers(m)


def expert_products_s(m: dict, B: int, S: int) -> float:
    """The least seconds of a step's grouped expert products, each at its own bound."""
    return sum(least_s(w) for w in expert_products(m, B, S))
