"""Serving example: batched prefill + decode with the paged KV tier.

The reference's defaults over ``repro_torch.launch.serve.main``: a reduced
qwen1.5-0.5b, batch 4, a 64-token prompt, 24 decode steps, and the KV of
sequence 0 spilled to donors and fetched back. On the card it launches the
CUDA flash-attention (prefill) and paged-attention (decode) kernels.

  PYTHONPATH=src python -m repro_torch.examples.serve_paged [--device cpu]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from repro_torch.launch.serve import ServeResult
from repro_torch.launch.serve import main as serve_main

DEFAULTS = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "4",
            "--prompt-len", "64", "--gen", "24", "--spill"]


def main(argv: Optional[List[str]] = None) -> ServeResult:
    """``argv`` (``--device`` included) goes after the defaults, so any
    flag of ``repro_torch.launch.serve`` overrides them."""
    return serve_main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
