"""Functors — PHAST's user-extensible parallel building block
(``repro.core.functor``).

A PHAST functor is a struct with ``operator()`` applied per element, per
row or per tile by ``phast::for_each``; linked captures (``vec.link``)
bring auxiliary containers into scope.  The paper's InnerProduct port
(Listing 1.2) defines ``matrixPlusVectorRows`` this way.  Here a functor
is a plain Python callable over tensors, mapped with ``torch.vmap``:

  * ``for_each_elementwise(f, x, *linked)`` — f over every element, the
    linked tensors broadcast against x
  * ``for_each_rows(f, m, *linked)`` — f over the rows of a matrix
  * ``matrix_plus_vector_rows(m, vec)`` — Listing 1.2's functor
  * ``for_each_tiles(f, x, tile)`` — f over the (th, tw) tiles of a
    zero-padded 2-D tensor, the result cropped back

As in JAX, a functor's body must be traceable by the map: tensor
operations only, no branch on a value.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def for_each_elementwise(f: Callable, x: torch.Tensor,
                         *linked: torch.Tensor) -> torch.Tensor:
    """``f(elem, *linked_elems)`` over every element of ``x``; ``linked``
    tensors are broadcast against ``x`` (PHAST's ``.link``)."""
    flat = x.reshape(-1)
    linked_flat = [torch.broadcast_to(t, x.shape).reshape(-1)
                   for t in linked]
    return torch.vmap(f)(flat, *linked_flat).reshape(x.shape)


def for_each_rows(f: Callable, m: torch.Tensor,
                  *linked: torch.Tensor) -> torch.Tensor:
    """``f(row, *linked)`` over the leading axis of ``m``: the analogue of
    ``phast::for_each(matC.begin_i(), matC.end_i(), functor)``."""
    return torch.vmap(lambda row: f(row, *linked))(m)


def matrix_plus_vector_rows(m: torch.Tensor,
                            vec: torch.Tensor) -> torch.Tensor:
    """The paper's ``matrixPlusVectorRows`` functor: ``vec`` added to every
    row."""
    return for_each_rows(lambda row, v: row + v, m, vec)


def for_each_tiles(f: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """``f(tile_2d)`` over a 2-D tensor in (th, tw) tiles: zero-padded to
    tile multiples, reshaped into the tile grid, mapped over its cells and
    cropped (the TPU execution model's reference lowering, where the
    kernel's grid is the same tile grid)."""
    th, tw = tile
    h, w = x.shape
    xp = F.pad(x, (0, (-w) % tw, 0, (-h) % th))
    gh, gw = xp.shape[0] // th, xp.shape[1] // tw
    tiles = xp.reshape(gh, th, gw, tw).permute(0, 2, 1, 3)
    out = torch.vmap(torch.vmap(f))(tiles)
    out = out.permute(0, 2, 1, 3).reshape(gh * th, gw * tw)
    return out[:h, :w]
