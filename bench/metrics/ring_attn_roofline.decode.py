"""``csrc/ring_attention.cu``'s share of its roofline in decode, %: each
traced step's calls (one a layer) over the live tokens only (each sequence's
length, capped by the window), q and the output, against the device time of
its kernels (the attention kernel and its combine). A program without the
kernel reads nothing here."""

from bench.lib import roofline
from bench.lib.readers import kernel_share

PATTERN = r"ring_attention_kernel|ring_attention_combine"


def read(r):
    m = r.model
    if not m.get("window"):
        return None

    def calls(lengths):
        live = sum(min(n, m["window"]) for n in lengths)
        work = roofline.paged_decode(int(live), len(lengths), m["num_heads"],
                                     m["num_kv_heads"], m["head_dim"], 0)
        return m["num_layers"] * roofline.least_s(work)
    return kernel_share(r, PATTERN, calls)
