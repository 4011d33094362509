#!/usr/bin/env python3
"""The JAX reference's shard-local MoE gradient, with and without JAX's
varying-axes check, against its global dispatch on the same function.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        PYTHONPATH=src python3 tools/moe_ep_grad_check.py

On a 2×2 ("data", "model") mesh of forced host devices, reduced
deepseek-v2-lite-16b (8 experts: EP, 4 a model shard) and qwen2-moe-a2.7b (6
experts: TP on ``moe_ff``) run ``loss_fn`` under ``moe_shard_map`` and without
it, at capacity factor 8 (no pair dropped) and no aux loss, so the two are the
same function of the weights. For each arch and each setting of
``jax.shard_map``'s ``check_vma`` it prints the loss of both and the relative
norm difference of a few gradients. The reference's code is not changed: the
script only sets ``check_vma`` around its call.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced
from repro.configs.optimized import optimize
from repro.launch.mesh import make_local_mesh
from repro.models import init_stack, loss_fn

LEAVES = ("router", "wi", "shared_wi")


def main() -> None:
    mesh = make_local_mesh(2, 2)
    shard_map = jax.shard_map
    for check_vma in (True, False):
        jax.shard_map = functools.partial(shard_map, check_vma=check_vma)
        for arch in ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b"):
            base = dataclasses.replace(get_reduced(arch), capacity_factor=8.0,
                                       router_aux_weight=0.0)
            cfg = optimize(base, only={"moe"})
            params, _ = init_stack(jax.random.PRNGKey(0), cfg)
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
            rng = np.random.default_rng(0)
            tok = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
            tgt = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
            grad = jax.jit(jax.value_and_grad(lambda p, c: loss_fn(p, tok, tgt, c),
                                              has_aux=True), static_argnums=1)
            with jax.set_mesh(mesh):
                (loss_knob, _), g_knob = grad(params, cfg)
                (loss_glob, _), g_glob = grad(params, base)
            diffs = {k: float(jnp.linalg.norm(g_knob["blocks"]["moe"][k]
                                              - g_glob["blocks"]["moe"][k])
                               / jnp.linalg.norm(g_glob["blocks"]["moe"][k]))
                     for k in LEAVES}
            diffs["embed"] = float(jnp.linalg.norm(g_knob["embed"] - g_glob["embed"])
                                   / jnp.linalg.norm(g_glob["embed"]))
            print(f"check_vma={check_vma} {arch}: loss {float(loss_knob)!r} (shard-local) "
                  f"{float(loss_glob)!r} (global); gradient relative differences "
                  + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    jax.shard_map = shard_map


if __name__ == "__main__":
    main()
