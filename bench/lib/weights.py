"""Weights drawn from the seed on the device, one large draw a layer group.

Both sides get the same values: the program's parameters are filled from
these draws in set-up, and the reference draws each group again, one at a
time, once the program is gone. A group's draw depends only on the seed
and the group's index, so any group can be drawn alone. Draws are made in
bfloat16, the dtype the configurations serve and train in.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DTYPE = torch.bfloat16
_MASK = (1 << 63) - 1


def group_seed(seed: int, index: int) -> int:
    """A generator seed for group ``index`` under the run's ``seed`` (any size)."""
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9 + 1) & _MASK


def _draw(n: int, seed: int, index: int, device: torch.device,
          out: torch.Tensor = None) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    return torch.randn(n, generator=gen, device=device, dtype=DTYPE, out=out)


class Weights:
    """The weights of one configuration under one seed.

    ``groups`` is the reference's ``groups(model)``: [(group, [(leaf, shape,
    init, scale)])]. ``group(name)`` draws that group again and returns its
    leaves; ``fill(params)`` writes every leaf into the matching tensors of a
    {full name: tensor} dict (the program's parameters), in place."""

    def __init__(self, groups, full_name, seed: int, device: torch.device) -> None:
        self.groups: List[Tuple[str, list]] = groups
        self.index = {g: i for i, (g, _) in enumerate(groups)}
        self.full_name = full_name
        self.seed, self.device = seed, torch.device(device)

    def names(self) -> List[str]:
        return [self.full_name(g, leaf[0]) for g, leaves in self.groups for leaf in leaves]

    def _normal(self, leaves) -> int:
        return sum(_numel(shape) for _, shape, init, _ in leaves if init == "normal")

    def group(self, name: str) -> Dict[str, torch.Tensor]:
        """{leaf: tensor} of one group, drawn again from the seed."""
        i = self.index[name]
        leaves = self.groups[i][1]
        flat = _draw(self._normal(leaves), self.seed, i, self.device)
        out, off = {}, 0
        for leaf, shape, init, scale in leaves:
            if init == "normal":
                n = _numel(shape)
                out[leaf] = flat[off:off + n].view(shape).mul_(scale)
                off += n
            else:
                out[leaf] = torch.full(shape, 1.0 if init == "ones" else 0.0,
                                       dtype=DTYPE, device=self.device)
        return out

    @torch.no_grad()
    def fill(self, params: Dict[str, torch.Tensor]) -> None:
        """Every leaf into ``params[full name]`` (same shape; any dtype). A
        group of one drawn leaf is drawn straight into its parameter."""
        missing = set(self.names()) ^ set(params)
        if missing:
            raise KeyError(f"program parameters and weights differ: {sorted(missing)[:8]}")
        for i, (g, leaves) in enumerate(self.groups):
            drawn = [leaf for leaf in leaves if leaf[2] == "normal"]
            if len(drawn) == 1 and params[self.full_name(g, drawn[0][0])].dtype == DTYPE:
                leaf, shape, _, scale = drawn[0]
                target = params[self.full_name(g, leaf)]
                if tuple(target.shape) != tuple(shape) or not target.is_contiguous():
                    raise ValueError(f"{self.full_name(g, leaf)}: shape {tuple(target.shape)}")
                _draw(target.numel(), self.seed, i, self.device, out=target.view(-1))
                target.mul_(scale)
                for other, shape, init, _ in leaves:
                    if init != "normal":
                        params[self.full_name(g, other)].fill_(1.0 if init == "ones" else 0.0)
                continue
            for leaf, t in self.group(g).items():
                target = params[self.full_name(g, leaf)]
                if tuple(target.shape) != tuple(t.shape):
                    raise ValueError(f"{self.full_name(g, leaf)}: shape {tuple(target.shape)}"
                                     f" against {tuple(t.shape)}")
                target.copy_(t)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
