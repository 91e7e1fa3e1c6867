"""Row softmax, fused softmax + cross-entropy and its backward — the
Hopper kernels of Caffe's Softmax and SoftmaxWithLoss.

Replace ``repro/kernels/softmax_xent.py:softmax_pallas``,
``softmax_xent_pallas`` and ``softmax_xent_bwd_pallas``.  One kernel template (``csrc/softmax_xent.cu``),
one warp per row, max and sum of exponentials in f32: softmax writes
``e / sum(e)``, softmax_xent ``exp(logp)`` and each row's NLL in f32,
whose mean over all B rows the wrapper takes (JAX takes it outside its
kernel too: ``softmax_xent.py:107``).  A label outside [0, V) gives its
row an NLL of 0, the rule of JAX's Pallas kernel (its one-hot never
matches such a label; JAX's oracle wraps -1 to the last class instead),
and the mean still divides by B.  The backward kernel writes ``(p -
onehot) / B`` from the saved probs, one warp per row as well; such a
row's one-hot is empty, so it gets ``p / B``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import softmax as softmax_ref
from repro_torch.kernels.ref import softmax_xent as softmax_xent_ref
from repro_torch.kernels.ref import softmax_xent_bwd as softmax_xent_bwd_ref


def _rows(name: str, x: torch.Tensor, labels=None):
    """Launch the row kernel on a (rows, V) matrix read by its strides;
    returns (probs, nll or None)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    rows, v = x.shape
    probs = torch.empty((rows, v), dtype=x.dtype, device=x.device)
    nll = None
    if labels is not None:
        nll = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if probs.numel() == 0:
        return probs, nll
    rc = _build.lib().repro_softmax_rows(
        x.data_ptr(), None if labels is None else labels.data_ptr(),
        probs.data_ptr(), None if nll is None else nll.data_ptr(), rows, v,
        x.stride(0), x.stride(1), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, name)
    return probs, nll


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, any leading rank, f32 inside, in
    ``x.dtype``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if not x.is_cuda:
        return softmax_ref(x)
    _build.guard_grad("softmax", x)
    if x.dim() == 0:
        raise ValueError("softmax: needs at least one axis")
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    probs, _ = _rows("softmax", x2)
    softmax.launches += 1
    return probs.reshape(x.shape)


def _check_labels(name: str, x: torch.Tensor, labels: torch.Tensor):
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.device != x.device:
        raise TypeError(f"{name}: labels must be integers on {x.device}, "
                        f"got {labels.dtype} on {labels.device}")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,V) logits, (B,) int labels -> (mean NLL f32 scalar, probs in the
    logits' dtype).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not logits.is_cuda:
        return softmax_xent_ref(logits, labels)
    _build.guard_grad("softmax_xent", logits)
    _check_labels("softmax_xent", logits, labels)
    probs, nll = _rows("softmax_xent", logits,
                       labels.to(torch.int64).contiguous())
    softmax_xent.launches += 1
    return nll.mean(), probs


def softmax_xent_bwd(probs: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """(B,V) probs, (B,) int labels -> ``(probs - onehot) / B`` in the
    probs' dtype, contiguous.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if not probs.is_cuda:
        return softmax_xent_bwd_ref(probs, labels)
    _build.guard_grad("softmax_xent_bwd", probs)
    _check_labels("softmax_xent_bwd", probs, labels)
    if probs.dtype not in DTYPES:
        raise TypeError(f"softmax_xent_bwd: dtype {probs.dtype} not "
                        "supported")
    rows, v = probs.shape
    out = torch.empty((rows, v), dtype=probs.dtype, device=probs.device)
    if out.numel() == 0:
        return out
    lab = labels.to(torch.int64).contiguous()
    rc = _build.lib().repro_softmax_xent_bwd(
        probs.data_ptr(), lab.data_ptr(), out.data_ptr(), rows, v,
        probs.stride(0), probs.stride(1), 1.0 / rows, DTYPES[probs.dtype],
        torch.cuda.current_stream(probs.device).cuda_stream,
    )
    _build.check(rc, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    return out


softmax.launches = 0
softmax_xent.launches = 0
softmax_xent_bwd.launches = 0
