"""Gradient compression with error feedback — the wire format of the
data-parallel all-reduce (``repro.optim.compress``).

Codecs:
  * none  — the f32 grads as they are.
  * bf16  — 2x reduction, no state beyond the error-feedback buffer.
  * int8  — 4x reduction, per-tensor symmetric scale
    ``max(max|g|, 1e-12) / 127`` in f32, rounded half to even, clipped
    to +-127; a tensor is a leaf of JAX's stacked layout, so the layers
    of one per-layer parameter share a scale.

Error feedback (Seide et al. / EF-SGD): the quantization residual is
added back into the next step's gradient.  Each function does JAX's
operations in JAX's order, leaf by leaf (bit for bit on the CPU).
``psum_compressed`` all-reduces the compressed payload over a
``torch.distributed`` group (gloo on the CPU, NCCL on the card): int8
payloads are renormalised to the group's largest scale and summed in
int32.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.convert import stacked_leaves
from repro_torch.optim.optimizers import tree_leaves, tree_map

CODECS = ("none", "bf16", "int8")


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _encode(corrected, codec: str):
    """(payload, scales) of a tree of f32 grads.  int8's scale is JAX's
    per-tensor scale, over the whole stacked leaf: every layer's tensor of
    one ``convert.stacked_leaves`` leaf shares one scale."""
    if codec == "bf16":
        return tree_map(lambda c: c.to(torch.bfloat16), corrected), None
    if codec != "int8":
        raise ValueError(codec)
    scale_of = {}
    for _, parts in stacked_leaves(corrected):
        flat = tree_leaves(parts)
        top = flat[0].abs().max()
        for c in flat[1:]:
            top = torch.maximum(top, c.abs().max())
        scale = torch.clamp(top, min=1e-12) / 127.0
        scale_of.update((id(c), scale) for c in flat)
    scales = tree_map(lambda c: scale_of[id(c)], corrected)
    payload = tree_map(
        lambda c, s: torch.clamp(torch.round(c / s), -127, 127)
        .to(torch.int8), corrected, scales)
    return payload, scales


def compress(grads, ef, codec: str = "bf16") -> Tuple[Any, Any, Any]:
    """grads + ef -> (quantized payload, scales (int8) or None, new error
    feedback)."""
    if codec == "none":
        return grads, None, ef
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef)
    payload, scales = _encode(corrected, codec)
    deq = decompress(payload, scales, codec)
    return payload, scales, tree_map(torch.sub, corrected, deq)


def decompress(payload, scales, codec: str = "bf16"):
    if codec == "none":
        return payload
    if codec == "bf16":
        return tree_map(lambda q: q.float(), payload)
    return tree_map(lambda q, s: q.float() * s, payload, scales)


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place, returning ``t``.  NCCL
    refuses strided tensors, and a weight's grad may be a transposed view:
    the collective runs on ``t``'s memory with its dims permuted by
    decreasing stride, so the caller's layout (and with it the summation
    order of the optimizer's global norm) is kept."""
    v = t
    if not t.is_contiguous():
        v = t.permute(sorted(range(t.dim()), key=lambda d: -t.stride(d)))
        if not v.is_contiguous():
            raise ValueError(f"a tensor of strides {t.stride()} is not a "
                             "dense layout")
    dist.all_reduce(v, op=op, group=group)
    return t


def psum_compressed(grads, ef, group: Optional[dist.ProcessGroup] = None,
                    codec: str = "bf16"):
    """All-reduce mean of the compressed grads over ``group`` (the default
    group when None).  Returns (reduced f32 grads, new error feedback);
    ``grads`` is left as it was."""
    payload, scales, new_ef = compress(grads, ef, codec)
    n = dist.get_world_size(group)

    if codec == "none":
        red = tree_map(lambda g: all_reduce_(g.to(torch.float32, copy=True),
                                             group) / n, payload)
        return red, new_ef
    if codec == "bf16":
        red = tree_map(lambda q: all_reduce_(q, group).float() / n, payload)
        return red, new_ef
    if codec != "int8":
        raise ValueError(codec)

    # one MAX per stacked leaf: its layers share the scale tensor
    smax = {}
    for s in tree_leaves(scales):
        if id(s) not in smax:
            smax[id(s)] = all_reduce_(s.clone(), group, dist.ReduceOp.MAX)

    def reduce_leaf(q, s):
        top = smax[id(s)]
        # renormalise the local payload to the common scale, then sum
        q32 = torch.round(q.float() * (s / top)).to(torch.int32)
        return all_reduce_(q32, group).float() * top / n

    return tree_map(reduce_leaf, payload, scales), new_ef
