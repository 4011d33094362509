"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``<name>/ops.py`` is the entry point: on a CUDA tensor it launches the
kernel from ``csrc/<name>.cu`` and counts the launch in ``launches``; on
a CPU tensor it runs the plain version. ``<name>/ref.py`` is the oracle.

On a meta tensor (the dry run: shapes only) each entry point goes through a
``torch.library.custom_op`` named ``repro_torch::<kernel>``: its fake gives
the outputs' shapes and dtypes, its formula registered with
``torch.utils.flop_counter.register_flop_formula`` the kernel's own
operations (the op's arguments with every tensor replaced by its shape and
the outputs' shapes as ``out_shape``, ``FlopCounterMode``'s convention), and
its formula in ``BYTES`` the bytes the kernel must move (each input read
once, each output written once; the op's arguments and its outputs as
``result``). The op's own body raises: CPU and CUDA tensors never reach it,
since the wrapper runs the plain version or launches the kernel itself.
These are the counts ``chip_smoke.py`` bounds each kernel with. A
kernel wrapper takes plain tensors only: a DTensor is refused
(``distributed.sharding.refuse_dtensor``).

AdamW (``adamw/``) is the exception: it runs over a whole model's leaves
and has no custom op. ``optim.adamw.update`` asks ``adamw.ops.plain_reason``
and sends leaves off the card (CPU and meta tensors, DTensors or not) to
the plain loop (``adamw/ref.py``), which is what the dry run counts; on the
card it hands the kernel a one-device mesh's DTensors as their shards.
"""

from __future__ import annotations

from typing import Callable, Dict

BYTES: Dict[object, Callable[..., int]] = {}     # op packet → its bytes formula


def meta_only(kernel: str) -> NotImplementedError:
    """The error a custom op's body raises: it has meta tensors only (its
    fake runs there); CPU and CUDA tensors go through the wrapper."""
    return NotImplementedError(f"repro_torch::{kernel} takes meta tensors only; on the "
                               "CPU or the card call its wrapper in kernels/*/ops.py")


def register_bytes(op) -> Callable:
    """Decorator: ``fn(*args, result=..., **kwargs) -> bytes`` for ``op``."""
    def deco(fn: Callable[..., int]) -> Callable[..., int]:
        BYTES[op] = fn
        return fn
    return deco
