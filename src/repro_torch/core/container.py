"""Containers — PHAST's layout tag and Caffe's Blob
(``repro.core.container``).

* ``MajorOrder`` and ``as_layout`` reproduce the paper's boundary
  pathology (§4.3): a row-major region handing a tensor to a column-major
  one pays a real relayout.  ``as_layout`` materializes it as JAX's does,
  transpose, copy, transpose: the logical values are unchanged and the
  storage is the transposed order (a 2-D result is column-major, its
  strides reversed), so the kernels downstream read it by its strides.
* ``Blob`` — Caffe's container: a ``data`` tensor and a lazily allocated
  ``diff`` of the same shape.  A plain dataclass: torch needs no pytree
  registration.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

import torch


class MajorOrder(enum.Enum):
    ROW = "row"        # PHAST / C order
    COLUMN = "column"  # OpenBLAS / Fortran order


def as_layout(x: torch.Tensor, src: MajorOrder,
              dst: MajorOrder) -> torch.Tensor:
    """Materialize a layout change (identity if ``src == dst`` or
    ``x.dim() < 2``): the storage of ``x`` transposed into a new tensor,
    viewed back in ``x``'s logical order."""
    if src == dst or x.dim() < 2:
        return x
    perm = tuple(reversed(range(x.dim())))
    return x.permute(perm).contiguous().permute(perm)


@dataclasses.dataclass
class Blob:
    """Caffe's Blob: data + diff of identical shape.

    ``diff`` is None until someone writes a gradient, so inference-only
    nets never pay for it.
    """

    data: torch.Tensor
    diff: Optional[torch.Tensor] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def count(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def num(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def with_data(self, data: torch.Tensor) -> "Blob":
        return Blob(data=data, diff=self.diff)

    def with_diff(self, diff: torch.Tensor) -> "Blob":
        return Blob(data=self.data, diff=diff)

    def ensure_diff(self) -> "Blob":
        if self.diff is None:
            return Blob(data=self.data, diff=torch.zeros_like(self.data))
        return self

    @staticmethod
    def zeros(shape: Sequence[int], dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> "Blob":
        return Blob(data=torch.zeros(tuple(shape), dtype=dtype,
                                     device=device))

    # reshape mirrors Caffe's Blob::Reshape (logical only)
    def reshape(self, shape: Sequence[int]) -> "Blob":
        return Blob(
            data=self.data.reshape(tuple(shape)),
            diff=None if self.diff is None else self.diff.reshape(
                tuple(shape)),
        )

    # PHAST-style typed views
    def as_matrix(self, rows: int, cols: int,
                  transpose: bool = False) -> torch.Tensor:
        m = self.data.reshape(rows, cols)
        return m.T if transpose else m

    def as_vector(self) -> torch.Tensor:
        return self.data.reshape(-1)
