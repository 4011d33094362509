"""The yardstick for a DeepSeek-V2 decoder (``bench/reference/mla_moe.py``'s
model: MLA on every layer, a dense SwiGLU on the first ``first_dense_layers``
layers and a mixture of experts after): the operations and least bytes of
a decode step and of its expert products, from shapes alone, against
``bench.lib.roofline``'s H100 peaks (``least_s``).

Bytes count each weight a step reads once, in bf16 (the router in f32, as the
program keeps it); of the routed experts, those that B tokens choosing
``top_k`` of ``num_experts`` are expected to touch, E·(1 − (1 − K/E)^B) a
layer (each token's picks taken as uniform and independent). Each live
token's latent (``kv_lora_rank`` + ``qk_rope_dim`` values a layer, bf16) is
read once. Operations are 2 a multiply-add of every product a token passes
through, the absorbed decode's included (q·W_kb into the latent, the latent
output up through W_vb), and the latent attention's 2·H·(2R + dr) a live
token a layer (scores against the latent and the rope key, the output over
the latent).
"""

from __future__ import annotations

from bench.lib.roofline import BF16, F32, Work


def _vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def _moe_layers(m: dict) -> int:
    return m["num_layers"] - m.get("first_dense_layers", 0)


def mla_params(m: dict) -> int:
    """Matrix parameters of one layer's MLA: W_q, W_kv_a, W_kb, W_vb, W_o."""
    M, H = m["d_model"], m["num_heads"]
    R, dr, dn, dv = m["kv_lora_rank"], m["qk_rope_dim"], m["qk_nope_dim"], m["v_head_dim"]
    return M * H * (dn + dr) + M * (R + dr) + R * H * (dn + dv) + H * dv * M


def experts_touched(m: dict, B: int) -> float:
    """Routed experts a layer that B tokens are expected to touch."""
    E, K = m["num_experts"], m["top_k"]
    return E * (1.0 - (1.0 - K / E) ** B)


def expert_bytes(m: dict, B: int) -> float:
    """Bytes of the routed experts' three matrices a step reads, every MoE layer."""
    return _moe_layers(m) * experts_touched(m, B) * 3 * m["d_model"] * m["moe_d_ff"] * BF16


def expert_products(m: dict, B: int) -> Work:
    """The grouped expert products of one decode step of B tokens, every MoE
    layer: the touched experts' weights once, B·K rows of d_model in and out
    (bf16); 2·B·K·3·M·F operations a layer."""
    M, Fe, K = m["d_model"], m["moe_d_ff"], m["top_k"]
    L = _moe_layers(m)
    flops = L * 2.0 * B * K * 3 * M * Fe
    nbytes = expert_bytes(m, B) + L * 2 * B * K * M * BF16
    return flops, 0.0, nbytes


def decode_step(m: dict, lengths) -> Work:
    """One decode step of len(lengths) sequences, each attending over its
    length (tokens cached, this one included)."""
    B = len(lengths)
    M, V, H, L = m["d_model"], _vocab(m), m["num_heads"], m["num_layers"]
    R, dr = m["kv_lora_rank"], m["qk_rope_dim"]
    E, K, Fe = m["num_experts"], m["top_k"], m["moe_d_ff"]
    Fs = m.get("num_shared_experts", 0) * Fe
    dense_l, moe_l = L - _moe_layers(m), _moe_layers(m)
    live = int(sum(lengths))
    # products a token passes through, as parameters (multiply-adds)
    per_token = (L * mla_params(m) + dense_l * 3 * M * m["d_ff"]
                 + moe_l * (M * E + K * 3 * M * Fe + 3 * M * Fs) + M * V)
    bf16 = 2.0 * B * per_token + L * 2.0 * H * (2 * R + dr) * live
    nbytes = (BF16 * (L * (mla_params(m) + 2 * M + R) + dense_l * 3 * M * m["d_ff"]
                      + moe_l * 3 * M * Fs + M * V + M)
              + F32 * moe_l * M * E
              + expert_bytes(m, B)
              + BF16 * B * M                               # the embedding rows
              + BF16 * L * live * (R + dr)                 # the live latent
              + BF16 * B * V)                              # the logits written
    return bf16, 0.0, nbytes
