"""Beyond-paper perf knobs: the reference's ``configs/optimized.py``.

``optimize(cfg, only=...)`` flips the same fields to the same values as the
reference's: ``flash_bf16``; ``blocks`` (query and key tiles of 1024);
``swa`` (a sliding-window arch reads a fixed slice of keys a query block);
``moe`` (shard-local MoE dispatch, ``models/moe.py``); ``ssd_chunk`` and
``ssd_chunk128`` (scan chunks of 64 and 128); ``mla_lat`` (MLA decode scores
as a partial sum over the latent's shards, ``models/mla.py``). ``only=None``
applies ``DEFAULT_ON``; ``only=set()`` changes nothing.

``DEFAULT_ON`` is the port's own. The reference's set was confirmed on a TPU,
and no statement about speed carries over. Here a knob is on by default only
where the port's dry run (``launch.dryrun``, 16×16, one knob at a time against
``base``, the H100 constants of ``roofline.analysis``) shows that it lowers the
largest term (compute, minimum memory or collective) of at least one
full-size cell it touches and raises no term of any cell by more than 1 %
(``tools/knob_table.py``). The table that decided it is ``PERF.md`` §6,
"The knobs on the dry run": ``moe`` lowers the collective term of the MoE
cells; ``mla_lat`` raises deepseek's decode collectives; the scan chunks
lower only the compute term, never the largest; the attention knobs change
no count, since on the card the flash kernel has its own tiles, skips the
blocks left of a window and rounds P to bf16 on its bf16 path whatever the
knobs say (``models/attention.py``): they set only the plain version's
tiles and rounding, on the CPU.
"""

from __future__ import annotations

from typing import Optional, Set

from .base import ModelConfig, replace

KNOBS = ("flash_bf16", "blocks", "swa", "moe", "ssd_chunk", "ssd_chunk128",
         "mla_lat")

DEFAULT_ON = {"moe"}


def optimize(cfg: ModelConfig, only: Optional[Set[str]] = None) -> ModelConfig:
    on = set(DEFAULT_ON) if only is None else set(only)
    kw = {}
    if "flash_bf16" in on:
        kw["flash_bf16"] = True
    if "blocks" in on:
        kw["attn_q_block"] = 1024
        kw["attn_kv_block"] = 1024
    if "swa" in on and cfg.window is not None:
        kw["swa_sliced_kv"] = True
    if "moe" in on and cfg.num_experts:
        kw["moe_shard_map"] = True
    if "ssd_chunk" in on and cfg.uses_ssm:
        kw["ssm_chunk"] = 64
    if "ssd_chunk128" in on and cfg.uses_ssm:
        kw["ssm_chunk"] = 128
    if "mla_lat" in on and cfg.attention == "mla":
        kw["mla_latent_psum"] = True
    return replace(cfg, **kw)
