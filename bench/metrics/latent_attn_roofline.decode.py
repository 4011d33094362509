"""``csrc/latent_attention.cu``'s share of its roofline in decode, %: each
traced step's calls (one a layer) over the live latent only (each sequence's
length of latent and rope-key values, bf16), q_lat and o_lat (f32) and q_pe
(bf16), against the device time of its kernels (the attention kernel and its
combine). A program without the kernel reads nothing here."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"latent_attention_kernel|latent_attention_combine"


def step_work(m: dict, lengths) -> roofline.Work:
    """One decode step's latent attention, every layer: each live token's
    ``kv_lora_rank`` + ``qk_rope_dim`` values read once, q_lat read and o_lat
    written in f32, q_pe read; 2·H·(2R + dr) operations a live token."""
    B, H, L = len(lengths), m["num_heads"], m["num_layers"]
    R, dr = m["kv_lora_rank"], m["qk_rope_dim"]
    live = int(sum(lengths))
    nbytes = L * (live * (R + dr) * roofline.BF16 + 2 * B * H * R * roofline.F32
                  + B * H * dr * roofline.BF16)
    return L * 2.0 * H * (2 * R + dr) * live, 0.0, nbytes


def read(r):
    if not r.model.get("kv_lora_rank"):
        return None
    return kernel_share(r, PATTERN,
                        lambda lengths: roofline.least_s(step_work(r.model, lengths)))
