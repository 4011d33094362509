"""End-to-end example: train the ~100M-param model for a few hundred steps.

Twin of the reference's ``examples/train_lm.py``: a thin wrapper over
``repro_torch.launch.train`` with the paper-era defaults (AdamW, async
checkpointing with resume, RDMAbox offload of the optimizer's first
moment). ~100M params is the full rdmabox-paper-100m config; pass
``--reduced`` for a quick run, ``--device cpu`` to run without a card.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --reduced --steps 50 --device cpu
"""

from __future__ import annotations

import sys
from typing import List, Optional

from repro_torch.launch import train

DEFAULTS = ["--arch", "rdmabox-paper-100m", "--batch", "8", "--seq", "512",
            "--ckpt-every", "100", "--offload"]


def main(argv: Optional[List[str]] = None) -> train.TrainResult:
    return train.main(DEFAULTS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
