"""Logical-axis → mesh-axis sharding rules, and the DTensor boundary.

Twin of ``repro/distributed/sharding.py``. Every parameter and cache
tensor has a tuple of logical axis names (``models.transformer.logical_axes``,
``cache_specs``); this module maps them to placements on a
``torch.distributed.DeviceMesh``. Rules are overridable per arch
(``ModelConfig.sharding_overrides``), e.g. qwen2-moe shards expert FFN
columns because 60 experts don't divide the model axis.

Divisibility fallback: a mesh axis that does not divide the corresponding
dim is dropped for that leaf (replicated on that axis) rather than failing,
and a mesh axis shards at most one dim of a leaf.

``spec_for`` returns the reference's ``PartitionSpec`` entries as a tuple
(an axis name, a tuple of names, or ``None`` per dim, trailing ``None``s
dropped); ``placements`` turns one into DTensor placements, one ``Shard`` or
``Replicate`` per mesh dim. ``on_local_shards`` is where a DTensor computation
meets a kernel: the kernel wrappers take plain tensors only. A mixer that
computes this device's term of a sum returns it as a ``Partial`` DTensor and
reduces it once with ``settle``: written in DTensor ops, DTensor makes the
``Partial`` (MLA's latent scores, ``models/mla.py``); laid out by hand on the
local shards, each input comes from ``to_local(grad_placements=...)`` and the
output goes back through ``DTensor.from_local`` (the MoE's shard-local
dispatch, ``models/moe.py``).

A DTensor step is one program on every rank: each rank plans and caches its
own sequences (``Shards.rows``), an input replicated over a mesh dim that a
kernel's outputs split gets its gradient back as a partial sum, and the
residual stream's partial sums are reduced where they join it (``settle``)
so that the next product shards its work rather than gathering its weight
(``keep_grad_sharded`` does the same for gradients).
``tests/test_torch_mesh_ranks.py`` holds every rank of a 2×2 gloo mesh to
the plain model.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from ..configs.base import ModelConfig

AxisRule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisRule, ...]

DEFAULT_RULES: Dict[str, AxisRule] = {
    # weights
    "vocab": "model",
    "embed": None,
    "q_flat": "model",
    "kv_flat": "model",
    "ffn": "model",
    "experts": "model",
    "moe_ff": None,
    "ssm_inner": "model",
    "lora": None,
    "layers": None,
    # activations / caches
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "kv_lora": "model",      # MLA latent cache feature dim
    "ssm_heads": "model",    # SSM decode state heads (divisibility fallback)
    # optimizer state re-maps "embed" → "data" (ZeRO-1); see optim_rules()
}


def rules_for(cfg: Optional[ModelConfig] = None,
              extra: Optional[Dict[str, AxisRule]] = None) -> Dict[str, AxisRule]:
    rules = dict(DEFAULT_RULES)
    if cfg is not None:
        rules.update(dict(cfg.sharding_overrides))
    if extra:
        rules.update(extra)
    return rules


def optim_rules(cfg: Optional[ModelConfig] = None) -> Dict[str, AxisRule]:
    """ZeRO-1 style: optimizer moments additionally shard the (normally
    replicated) "embed" axis across the data axis."""
    r = rules_for(cfg)
    r["embed"] = "data"
    return r


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping, as given)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Dict[str, AxisRule]) -> Spec:
    """The reference's PartitionSpec entries for one leaf, with divisibility
    fallback."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} vs logical axes {tuple(logical)}")
    sizes = mesh_shape(mesh)
    used: set = set()
    entries: list = []
    for dim, name in zip(shape, logical):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        names = (rule,) if isinstance(rule, str) else tuple(rule)
        names = tuple(n for n in names if n in sizes and n not in used)
        size = math.prod(sizes[n] for n in names) if names else 1
        if not names or size <= 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names if len(names) > 1 else names[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec: for each mesh dim, ``Shard(d)`` when the
    spec puts that axis on tensor dim d, else ``Replicate()``. Axes sharing a
    dim (("pod", "data") on the batch) split it major to minor, in mesh
    order, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh.mesh_dim_names)


def tree_shardings(tree: Mapping[str, Any], spec_tree: Mapping[str, Sequence],
                   mesh, rules: Dict[str, AxisRule]) -> Dict[str, tuple]:
    """{name: placements} for every leaf of ``tree`` (tensors or anything with
    a ``.shape``) from its logical axes in ``spec_tree``."""
    if set(tree) != set(spec_tree):
        raise ValueError(f"param/spec tree mismatch: {sorted(set(tree) ^ set(spec_tree))}")
    return {n: placements(spec_for(tuple(t.shape), spec_tree[n], mesh, rules), mesh)
            for n, t in tree.items()}


def batch_spec(mesh, batch: Optional[int] = None) -> Spec:
    """Batch sharding over (pod, data), dropping axes that don't divide."""
    sizes = mesh_shape(mesh)
    names = tuple(n for n in ("pod", "data") if n in sizes)
    if batch is not None:
        while names and batch % math.prod(sizes[n] for n in names):
            names = names[1:] if len(names) > 1 else ()
    if not names:
        return ()
    return (names if len(names) > 1 else names[0],)


def distribute(t: torch.Tensor, mesh, pl: tuple):
    """``t`` as a DTensor on ``mesh`` with placements ``pl``: a meta tensor
    (shapes only) becomes its meta shard with no collective, anything else
    goes through ``distribute_tensor``."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    if t.device.type != "meta":
        return distribute_tensor(t.detach(), mesh, pl)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                              run_check=False)


# ---------------------------------------------------------------------------
# the DTensor boundary
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without loading DTensor's module: no
    DTensor exists before it is loaded, and loading it (some 500 modules)
    on the serving path would slow the host's Python threads."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(t, dt.DTensor)


Dims = Tuple[Optional[int], Optional[int]]      # (batch dim, head dim) of a tensor


def head_split(mesh, heads: Sequence[int]) -> int:
    """How many ways "model" splits the heads of a call whose head counts are
    ``heads`` (query heads first): the model axis's size when it divides
    the query heads and every other count either divides by it or (GQA with
    fewer KV heads than shards) divides it, so each shard's query heads
    read whole KV heads; else 1."""
    m = mesh_shape(mesh).get("model", 1)
    H = heads[0]
    if m <= 1 or H % m:
        return 1
    if all(h % m == 0 or (m % h == 0 and H % h == 0) for h in heads[1:]):
        return m
    return 1


def local_heads(h: int, heads: Sequence[int], split: int) -> int:
    """Heads of a count-``h`` axis on one shard: h / split when it divides,
    else the KV heads one shard's H / split query heads read (a KV axis
    replicated over "model" and sliced per shard)."""
    if split == 1 or h % split == 0:
        return h // split
    return max(1, h * (heads[0] // split) // heads[0])


def head_placements(mesh, batch: int, heads: Sequence[int], dims: Dims,
                    size: Optional[int] = None) -> tuple:
    """Placements of a tensor whose dim ``dims[0]`` is the batch and
    ``dims[1]`` a head axis of ``size`` heads (default: the query heads,
    ``heads[0]``): the batch over ``batch_spec``'s axes, the heads over
    "model" when ``head_split`` splits them and ``size`` divides, else
    replicated (a KV axis then sliced per shard by ``Shards.to_local``)."""
    from torch.distributed.tensor import Replicate, Shard
    bnames = batch_spec(mesh, batch)
    bnames = set(bnames[0] if bnames and not isinstance(bnames[0], str) else bnames)
    split = head_split(mesh, heads)
    size = heads[0] if size is None else size
    out = []
    for name in mesh.mesh_dim_names:
        if name in bnames and dims[0] is not None:
            out.append(Shard(dims[0]))
        elif name == "model" and split > 1 and size % split == 0 and dims[1] is not None:
            out.append(Shard(dims[1]))
        else:
            out.append(Replicate())
    return tuple(out)


def on_local_shards(fn: Callable, args: Sequence[Optional[torch.Tensor]],
                    dims: Sequence[Dims], out_dims: Sequence[Dims], *, batch: int,
                    heads: Sequence[int]):
    """``fn(*args)`` on plain tensors. With no DTensor among ``args`` it is
    just the call. Otherwise each argument becomes this device's shard under
    ``head_placements`` for its ``dims`` (``Shards.to_local``), ``fn`` runs on
    the shards, and each output becomes a DTensor with the placements of its
    ``out_dims``. This is the only way a kernel meets a DTensor computation:
    the kernel wrappers refuse DTensors."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Shard
    shards = Shards(mesh, batch)
    split = {i for d in out_dims for i, p in enumerate(head_placements(mesh, batch, heads, d))
             if isinstance(p, Shard)}
    out = fn(*(shards.to_local(a, d, heads, split) for a, d in zip(args, dims)))
    if out is None:
        return None
    single = isinstance(out, torch.Tensor)
    wrapped = tuple(shards.to_global(o, d, heads)
                    for o, d in zip((out,) if single else out, out_dims))
    return wrapped[0] if single else wrapped


@dataclass(frozen=True)
class Shards:
    """This device's part of a tensor computed on ``mesh`` for a global
    ``batch``: the batch over ``batch_spec``'s axes, head axes over "model"
    where they divide (``head_placements``). A decode cache built for a
    DTensor step holds only its shards, as plain tensors: the local batch
    (this rank's sequences, ``rows``) and its heads."""

    mesh: Any
    batch: int

    @property
    def _batch_axes(self) -> Tuple[str, ...]:
        spec = batch_spec(self.mesh, self.batch)
        return (spec[0],) if spec and isinstance(spec[0], str) else (spec[0] if spec else ())

    @property
    def local_batch(self) -> int:
        return self.batch // math.prod(mesh_shape(self.mesh)[n] for n in self._batch_axes)

    def rows(self, host):
        """This device's rows of a (batch, ...) host array: the sequences its
        shard of the batch holds (its coordinates on the batch axes, major
        to minor)."""
        rank = 0
        for name in self._batch_axes:
            rank = rank * self.mesh.size(self.mesh.mesh_dim_names.index(name)) \
                + self.mesh.get_local_rank(name)
        n = self.local_batch
        return host[rank * n:(rank + 1) * n]

    def local_heads(self, *heads: int) -> Tuple[int, ...]:
        """Each count of ``heads`` (query heads first) on this device."""
        split = head_split(self.mesh, heads)
        return tuple(local_heads(h, heads, split) for h in heads)

    def to_local(self, t, dims: Dims, heads: Sequence[int], split=()):
        """This device's shard of ``t``: a DTensor redistributed and
        unwrapped, a plain tensor with a batch dim taken as global (this
        rank's rows), any other plain tensor as it is (already local). A KV
        axis replicated over "model" keeps only the heads this shard's query
        heads read. ``split``: the mesh dims the computation's outputs are
        sharded over; a DTensor replicated on one of them gets back a partial
        gradient there (each device used it for its own part of the output)."""
        from torch.distributed.tensor import Partial, Replicate, distribute_tensor
        size = t.shape[dims[1]] if t is not None and dims[1] is not None else None
        pl = head_placements(self.mesh, self.batch, heads, dims, size)
        if is_dtensor(t):
            grad_pl = tuple(Partial() if i in split and isinstance(p, Replicate) else p
                            for i, p in enumerate(pl))
            t = t.redistribute(self.mesh, pl).to_local(grad_placements=grad_pl)
        elif t is not None and dims[0] is not None:
            t = distribute_tensor(t, self.mesh, pl).to_local()
        else:
            return t
        split = head_split(self.mesh, heads)
        if size is not None and split > 1 and size % split:
            n = local_heads(size, heads, split)
            first = self.mesh.get_local_rank("model") * (heads[0] // split) * size // heads[0]
            t = t.narrow(dims[1], first, n)
        return t

    def to_global(self, t: torch.Tensor, dims: Dims, heads: Sequence[int]):
        """This device's shard as a DTensor with these placements."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh,
                                  head_placements(self.mesh, self.batch, heads, dims),
                                  run_check=False)


def _unshard(t, over) -> torch.Tensor:
    """``t`` replicated on the mesh dims ``over``."""
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if i in over else p
                                          for i, p in enumerate(t.placements)])


def _unflatten(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``, a DTensor first replicated on the mesh
    dims sharding ``dim`` unless they divide ``sizes[0]`` (DTensor cannot
    split an uneven shard: 40 heads over 16)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        dim %= t.ndim
        over = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]
        if over and sizes[0] % math.prod(t.device_mesh.size(i) for i in over):
            t = _unshard(t, over)
    return t.unflatten(dim, sizes)


def _flatten(t: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``t.flatten(start, end)``, a DTensor first replicated on the mesh dims
    that shard one of those dims unevenly (60 experts over 16)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        start, end = start % t.ndim, end % t.ndim
        over = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)
                and start <= p.dim <= end and t.shape[p.dim] % t.device_mesh.size(i)]
        if over:
            t = _unshard(t, over)
    return t.flatten(start, end)


class _Unflatten(torch.autograd.Function):
    """``_unflatten`` whose gradient is ``_flatten``: the same rule both ways,
    whatever placement the gradient arrives in."""

    @staticmethod
    def forward(ctx, t, dim: int, sizes):
        ctx.dim, ctx.n = dim % t.ndim, len(sizes)
        return _unflatten(t, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _flatten(g, ctx.dim, ctx.dim + ctx.n - 1), None, None


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, start: int, end: int):
        ctx.start, ctx.sizes = start % t.ndim, tuple(t.shape[start:end % t.ndim + 1])
        return _flatten(t, start, end)

    @staticmethod
    def backward(ctx, g):
        return _unflatten(g, ctx.start, ctx.sizes), None, None


def split_last(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t``'s last dim split into ``sizes`` (heads × head dim); on a
    DTensor, uneven shards are replicated first, in the forward and the
    backward."""
    if is_dtensor(t):
        return _Unflatten.apply(t, -1, sizes)
    return t.unflatten(-1, sizes)


def split_rows(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t``'s first dim split into ``sizes``, as ``split_last``."""
    if is_dtensor(t):
        return _Unflatten.apply(t, 0, sizes)
    return t.unflatten(0, sizes)


def flatten(t: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``t.flatten(start, end)``; on a DTensor, uneven shards are replicated
    first, in the forward and the backward."""
    if is_dtensor(t):
        return _Flatten.apply(t, start, end)
    return t.flatten(start, end)


class _ReplicatedReshape(torch.autograd.Function):
    """A DTensor replicated, then reshaped; its gradient replicated, then
    reshaped back. DTensor's view of a dim sharded over two mesh axes
    ((pod, data) on the batch) can compute the wrong local shape."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = t.shape
        return replicate(t).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return replicate(g).reshape(ctx.shape), None


def reshape_replicated(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``; a DTensor is replicated on every mesh axis
    first, in the forward and the backward."""
    if is_dtensor(t):
        return _ReplicatedReshape.apply(t, shape)
    return t.reshape(shape)


def replicate(t):
    """A DTensor replicated on every mesh axis; anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _reduced(t):
    """``t`` with its partial sums reduced (partial → replicated)."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


class _Settle(torch.autograd.Function):
    """Partial sums reduced in the forward, and in the backward too: the
    gradient arrives replicated, whatever partial the input held."""

    @staticmethod
    def forward(ctx, t):
        return _reduced(t)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g)


class _KeepGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the placements the
    input had in the forward."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == tuple(ctx.placements):
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def keep_grad_sharded(t):
    """``t``; on a DTensor, its gradient is brought back to ``t``'s placements
    before it flows on. A product's output that later ops gather (sliced,
    normalised over its sharded dim) would otherwise pass back a gradient
    gathered too, and its weight gradient would be computed whole on every
    device."""
    return _KeepGrad.apply(t) if is_dtensor(t) and t.requires_grad else t


def settle(t):
    """A DTensor's pending partial sums reduced (partial → replicated), in
    the forward and the backward; the vocab-sharded lookup's masked partial
    sum must not be read twice, since its reduction frees the mask it needs.
    Anything else as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    return _Settle.apply(t)


def refuse_dtensor(what: str, *tensors) -> None:
    """Kernel wrappers take this device's plain tensors, never a DTensor."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{what} takes plain tensors: a DTensor reaches a kernel only "
                        "through distributed.sharding.on_local_shards")
