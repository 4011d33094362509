"""``csrc/paged_attention.cu``'s share of its roofline in decode, %: each
traced step's calls (one a layer) over the live tokens only, against the
device time of its kernels (the attention kernel and its combine)."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"paged_attention_kernel|paged_attention_combine"


def read(r):
    m, t = r.model, r.traffic
    per_seq = -(-t["capacity"] // t.get("page_tokens", 16))
    blocks = -(-per_seq // t.get("pages_per_block", 4))

    def calls(lengths):
        B = len(lengths)
        work = roofline.paged_decode(int(sum(lengths)), B, m["num_heads"],
                                     m["num_kv_heads"], m["head_dim"], B * blocks)
        return m["num_layers"] * roofline.least_s(work)
    return kernel_share(r, PATTERN, calls)
