"""Portable ops — the backend-switched, differentiable operator set the
model calls.

Every op is registered once in ``repro_torch.core.registry`` with its two
lowerings — the plain PyTorch version (``kernels/ref.py``) and the Hopper
kernel wrapper — and exposed as a plain function; the policy
(``repro_torch.core.policy``) decides per call from the backend and the
tensor's device which one runs.  Registered: the ops of the contiguous
and paged (and int8 paged) decode paths, of chunked prefill, of the
Mamba-2 blocks, of the full forward and of the Caffe layers (``relu``,
``im2col``, ``col2im``, ``conv2d``, ``maxpool``, ``softmax``,
``softmax_xent`` with both lowerings), and ``conv2d_direct``, the direct
convolution, with both lowerings (its reference lowering is
``ref.conv2d``, as JAX registers it); ``avgpool``, ``accuracy`` and
``layernorm`` are reference-only, as in JAX.  The set equals JAX's 23.

Differentiation mirrors ``repro.kernels.ops``.  When grad mode is on and
an input requires grad, the ops of the training forwards go through
autograd: the reference lowering is torch autograd of the plain version
(``matmul`` through a Function whose backward is ``_matmul_r_bwd``'s: the
cotangent cast to the operand's dtype, two f32-accumulated products;
``maxpool`` and ``softmax_xent`` through Functions whose backwards are
``ref.maxpool_bwd`` and ``ref.softmax_xent_bwd``, as JAX's custom VJPs:
all of a window's gradient to its stored argmax, and ``p / B`` for a row
whose label is outside [0, V)); the hopper lowering is an
``autograd.Function`` per op whose forward launches the kernel and whose
backward launches the backward kernels where the TPU port has them
(``matmul``: two more gemms; ``rmsnorm``: ``rmsnorm_bwd``; ``attention``:
``flash_attention_bwd`` from the saved out and lse; ``relu``:
``relu_bwd``; ``conv2d``: im2col again, two gemms and ``col2im``;
``maxpool``: ``maxpool_bwd`` where the windows do not overlap;
``softmax_xent``: ``softmax_xent_bwd`` with the cotangent folded in)
and is plain PyTorch where JAX's is jnp (``bias_add_rows``: ``(g,
g.sum(0))``; the convolution's bias gradient; ``col2im`` at a stride
other than 1 and the overlapping maxpool's scatter; ``ssd_scan``: the vjp
of the plain version, as JAX has no SSD backward kernel either).  The
reference-only ``avgpool`` takes, on both lowerings, ``AvgPoolFn``: the
plain forward and aten's one-launch pool backward in place of autograd's
``index_put_`` through the window gather.  A kernel wrapper called outside
these Functions on a tensor that requires grad raises
(``_build.guard_grad``) rather than cut the graph.  The serving ops
(decode, chunked prefill) are not differentiable, nor are the hopper
lowerings of ``softmax`` and ``conv2d_direct`` (JAX's ``softmax_pallas``
and ``conv2d_direct_pallas`` have no VJP either; the ``Softmax`` layer
appears only in the deploy form, and no layer calls ``conv2d_direct``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.policy import use_hopper
from repro_torch.core.registry import dispatch, register_op
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import softmax_xent as SX
from repro_torch.kernels._build import needs_grad
from repro_torch.kernels.conv_direct import (
    conv2d_direct as conv2d_direct_hopper,
)
from repro_torch.kernels.eltwise import bias_add_rows as bias_add_rows_hopper
from repro_torch.kernels.eltwise import relu as relu_hopper
from repro_torch.kernels.eltwise import relu_bwd as relu_bwd_hopper
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.im2col import col2im as col2im_hopper
from repro_torch.kernels.im2col import im2col as im2col_hopper
from repro_torch.kernels.mamba_scan import ssd_scan as ssd_scan_hopper
from repro_torch.kernels.pooling import maxpool as maxpool_hopper
from repro_torch.kernels.pooling import maxpool_bwd as maxpool_bwd_hopper
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_hopper
from repro_torch.kernels.rmsnorm import rmsnorm_bwd


class MatmulFn(torch.autograd.Function):
    """``fn(a, b)`` with the backward of ``repro/kernels/ops.py:71-99``:
    the cotangent cast to ``a.dtype`` (a no-op on the hopper lowering, whose
    output is in ``a.dtype``), then ``da = fn(g, b^T)`` and ``db = fn(a^T,
    g)``, f32-accumulated and written in the operands' dtypes.  ``fn`` is
    the lowering: ``gemm`` (both backward products are kernel launches,
    the transposes read by their strides) or ``ref.gemm``."""

    @staticmethod
    def forward(ctx, a, b, fn):
        ctx.save_for_backward(a, b)
        ctx.fn = fn
        return fn(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        da = ctx.fn(g, b.T, out_dtype=a.dtype) if ctx.needs_input_grad[0] \
            else None
        db = ctx.fn(a.T, g, out_dtype=b.dtype) if ctx.needs_input_grad[1] \
            else None
        return da, db, None


class BiasAddRowsFn(torch.autograd.Function):
    """The bias kernel forward; backward ``(g, g.sum(0))`` in plain torch,
    as ``ops.py:123-124`` is jnp."""

    @staticmethod
    def forward(ctx, m, v):
        return bias_add_rows_hopper(m, v)

    @staticmethod
    def backward(ctx, g):
        return g, g.sum(dim=0)


class RMSNormFn(torch.autograd.Function):
    """The RMSNorm kernel forward and the ``rmsnorm_bwd`` kernel backward
    (``ops.py:368-381``)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_hopper(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, None


class AttentionFn(torch.autograd.Function):
    """The flash-attention forward, saving ``(q, k, v, out, lse)``, and the
    ``flash_attention_bwd`` kernel backward (``ops.py:398-418``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = FA.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = FA.flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), causal=causal, window=window,
            scale=scale)
        return dq, dk, dv, None, None, None


class SSDScanFn(torch.autograd.Function):
    """The SSD scan kernel forward from a zero state; backward the vjp of
    the plain version (``ops.py:682-688``: JAX has no SSD backward kernel
    either)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, chunk):
        ctx.save_for_backward(x, dt, A, B_, C)
        ctx.chunk = chunk
        return ssd_scan_hopper(x, dt, A, B_, C, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ref.ssd_scan(*inputs, chunk=ctx.chunk)[0]
        return (*torch.autograd.grad(y, inputs, dy), None)


class ReluFn(torch.autograd.Function):
    """The relu kernel forward, saving x, and the ``relu_bwd`` kernel
    backward (``repro/kernels/ops.py:139-151``)."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return relu_hopper(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return relu_bwd_hopper(x, g, ctx.slope), None


class Conv2dFn(torch.autograd.Function):
    """``conv2d_hopper`` forward, saving ``(x, w)``, and the backward of
    ``_conv2d_p_bwd`` (``repro/kernels/ops.py:203-222``): im2col again
    (the kernel, batch in the columns), ``dw = gemm(dy_flat, cols^T)`` and
    ``dcols = gemm(w_mat^T, dy_flat)`` (the transposes read by their
    strides), ``dx = col2im(dcols)`` (the (C*KH*KW, N*OH*OW) product read
    as (N, C*KH*KW, OH*OW) by its strides; the kernel at stride 1, the
    plain scatter otherwise, as ``ops.py:172-175``) and ``db`` in plain
    torch.
    ``dy_flat``, the (F, N*OH*OW) cotangent with the batch in its columns,
    is the one copy.  No ``dx`` is computed where x needs none (conv1
    reads the data), no im2col where w needs none, no ``db`` without a
    bias."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad):
        ctx.save_for_backward(x, w)
        ctx.opts = (stride, pad)
        return conv2d_hopper(x, w, b, stride=stride, pad=pad)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, pad = ctx.opts
        n = x.shape[0]
        f, c, kh, kw = w.shape
        dy_flat = dy.transpose(0, 1).reshape(f, -1).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            cols = im2col_hopper(x, kh, kw, stride, pad,
                                 batch_in_columns=True)
            dw = gemm(dy_flat, cols.T).view(w.shape)
        if ctx.needs_input_grad[0]:
            # (C*KH*KW, N*P), read as (N, C*KH*KW, P) by its strides
            dcols = gemm(w.reshape(f, -1).T, dy_flat).view(
                c * kh * kw, n, -1).transpose(0, 1)
            dx = (col2im_hopper if stride == 1 else ref.col2im)(
                dcols, tuple(x.shape), kh, kw, stride, pad)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2, 3))
        return dx, dw, db, None, None


class MaxPoolFn(torch.autograd.Function):
    """One pool evaluation returning ``(out, argmax)``, the argmax not
    differentiable; the backward sends each window's gradient to its
    stored argmax, as ``_maxpool_arg_p`` / ``_maxpool_arg_r``
    (``repro/kernels/ops.py:239-282``).  ``hopper``: the maxpool kernel
    forward and the ``maxpool_bwd`` kernel backward where stride >= k,
    the plain scatter ``ref.maxpool_bwd`` for overlapping windows; else
    the plain versions both ways."""

    @staticmethod
    def forward(ctx, x, k, stride, pad, hopper):
        out, arg = (maxpool_hopper if hopper else ref.maxpool)(x, k, stride,
                                                               pad)
        ctx.mark_non_differentiable(arg)
        ctx.save_for_backward(arg)
        ctx.opts = (tuple(x.shape), k, stride, pad, hopper)
        return out, arg

    @staticmethod
    def backward(ctx, g, _):
        (arg,) = ctx.saved_tensors
        x_shape, k, stride, pad, hopper = ctx.opts
        bwd = maxpool_bwd_hopper if hopper and stride >= k \
            else ref.maxpool_bwd
        return bwd(g, arg, x_shape, k, stride, pad), None, None, None, None


class XentFn(torch.autograd.Function):
    """The mean NLL, saving ``(probs, labels)``; backward
    ``softmax_xent_bwd(probs, labels) * g``, as JAX's
    (``repro/kernels/ops.py:318-352``, the ``* g`` outside its kernel).
    ``hopper``: the softmax_xent kernel forward, and the softmax_xent_bwd
    kernel with ``g`` folded in (one launch, the same bits as the kernel
    then ``* g``); else the plain versions."""

    @staticmethod
    def forward(ctx, logits, labels, hopper):
        loss, probs = (SX.softmax_xent if hopper else ref.softmax_xent)(
            logits, labels)
        ctx.save_for_backward(probs, labels)
        ctx.hopper = hopper
        return loss

    @staticmethod
    def backward(ctx, g):
        probs, labels = ctx.saved_tensors
        if ctx.hopper:
            return SX.softmax_xent_bwd(probs, labels, g), None, None
        return ref.softmax_xent_bwd(probs, labels) * g, None, None


def avgpool_plan(k: int, stride: int, pad: int, h: int, w: int) -> str:
    """The average pool's backward under autograd, from the window and the
    plane's size: "gather" (``AvgPoolFn``: aten's ``avg_pool2d_backward``,
    one launch that gathers each input pixel's windows) where aten takes
    the window (a pad of at most half of it, at least one output);
    "windows" (autograd of ``ref.avgpool``'s window gather: an
    ``index_put_`` with accumulation, on CUDA a sort) for the rest."""
    out = min(ref.conv_out_size(h, k, stride, pad),
              ref.conv_out_size(w, k, stride, pad))
    return "gather" if 2 * pad <= k and out >= 1 else "windows"


class AvgPoolFn(torch.autograd.Function):
    """The average pool with a one-launch backward, on either backend
    (avgpool is reference-only, as in JAX: no kernel of the port's).
    Forward: ``ref.avgpool``, its values unchanged.  Backward: aten's
    ``avg_pool2d_backward`` at the floor rule with divisor k*k, JAX's
    windows (``repro/kernels/ref.py:212-226``): each window sends ``g /
    (k*k)`` to each of its taps, padding taps dropped, as the transpose of
    JAX's ``mean`` does."""

    @staticmethod
    def forward(ctx, x, k, stride, pad):
        ctx.save_for_backward(x)
        ctx.opts = (k, stride, pad)
        return ref.avgpool(x, k, stride, pad)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        k, stride, pad = ctx.opts
        dx = torch.ops.aten.avg_pool2d_backward(
            g, x, (k, k), (stride, stride), (pad, pad), False, True, k * k)
        return dx, None, None, None


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N), f32 accumulation, output in ``a.dtype``;
    param-dtype cotangents."""
    fn = dispatch("matmul", a)
    if needs_grad(a, b):
        return MatmulFn.apply(a, b, fn)
    return fn(a, b)


def bias_add_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if needs_grad(m, v) and use_hopper(m):
        return BiasAddRowsFn.apply(m, v)
    return dispatch("bias_add_rows", m)(m, v)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Reference-only, as in JAX (``repro/kernels/ops.py:391-392``)."""
    return ref.layernorm(x, w, b, eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    if needs_grad(x, w) and use_hopper(x):
        return RMSNormFn.apply(x, w, eps)
    return dispatch("rmsnorm", x)(x, w, eps)


def attention_decode(
    q: torch.Tensor,          # (B, Hq, D)
    k_cache: torch.Tensor,    # contiguous: (B, Smax, Hkv, D);
                              # paged: (P, page_size, Hkv, D) page pool
    v_cache: torch.Tensor,
    cache_len,                # int32 () or (B,): valid prefix incl. new token
    *,
    block_table: Optional[torch.Tensor] = None,  # (B, max_blocks) int32
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over the KV cache.  The layout switch
    point: ``block_table=None`` selects the contiguous per-row slab, a
    block table the shared page pool (``repro_torch.serving.pager``);
    ``kv_scales=(ksc, vsc)``, (P, Hkv) f32 each, marks an int8 pool."""
    if block_table is not None:
        if kv_scales is not None:
            ksc, vsc = kv_scales
            return dispatch("attention_decode_paged_quant", q)(
                q, k_cache, v_cache, ksc, vsc, cache_len, block_table,
                window=window, scale=scale,
            )
        return dispatch("attention_decode_paged", q)(
            q, k_cache, v_cache, cache_len, block_table, window=window,
            scale=scale,
        )
    _contiguous_unquantized(kv_scales)
    return dispatch("attention_decode", q)(
        q, k_cache, v_cache, cache_len, window=window, scale=scale
    )


def attention_prefill_chunk(
    q: torch.Tensor,          # (B, C, Hq, D): C prompt tokens per row
    k_cache: torch.Tensor,    # contiguous (B, Smax, Hkv, D) or page pool
    v_cache: torch.Tensor,
    start,                    # int32 () or (B,): position of chunk token 0
    width,                    # int32 () or (B,): real tokens in the chunk
    *,
    block_table: Optional[torch.Tensor] = None,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the KV cache, the chunk's own K/V
    already written; the same layout and int8 switch as
    ``attention_decode``."""
    if block_table is not None:
        if kv_scales is not None:
            ksc, vsc = kv_scales
            return dispatch("attention_prefill_chunk_paged_quant", q)(
                q, k_cache, v_cache, ksc, vsc, start, width, block_table,
                window=window, scale=scale,
            )
        return dispatch("attention_prefill_chunk_paged", q)(
            q, k_cache, v_cache, start, width, block_table, window=window,
            scale=scale,
        )
    _contiguous_unquantized(kv_scales)
    return dispatch("attention_prefill_chunk", q)(
        q, k_cache, v_cache, start, width, window=window, scale=scale
    )


def _contiguous_unquantized(kv_scales) -> None:
    if kv_scales is not None:
        raise ValueError(
            "kv_scales needs the paged layout (block_table) — the "
            "contiguous slab is never quantized"
        )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention (B,Sq,Hq,D) x (B,Sk,Hkv,D) -> (B,Sq,Hq,D), query
    ``i`` at position ``i``.  Both lowerings also return the lse: the
    hopper lowering's backward reads it (``AttentionFn``)."""
    if needs_grad(q, k, v) and use_hopper(q):
        return AttentionFn.apply(q, k, v, causal, window, scale)
    return dispatch("attention", q)(q, k, v, causal=causal, window=window,
                                    scale=scale)[0]


def _ssd(name: str, x, dt, A, B_, C, chunk: int, state, out=None):
    """The chunk is clamped to the token count (a chunk longer than the
    sequence is the same math on padding).  The plain version takes
    grouped B/C; the kernel takes one state group and raises on more (no
    configuration has more)."""
    c = max(1, min(int(chunk), x.shape[1]))
    return dispatch(name, x)(x, dt, A, B_, C, chunk=c, initial_state=state,
                             final_state=out)


def ssd_scan(x, dt, A, B_, C, *, chunk: int = 64) -> torch.Tensor:
    """Mamba-2 SSD over a whole sequence from a zero state; B_/C
    (B,S,G,N).  Returns y (the serving scan, ``ssd_prefill_chunk``,
    carries the state)."""
    if needs_grad(x, dt, A, B_, C) and use_hopper(x):
        return SSDScanFn.apply(x, dt, A, B_, C,
                               max(1, min(int(chunk), x.shape[1])))
    return _ssd("ssd_scan", x, dt, A, B_, C, chunk, None)[0]


def ssd_prefill_chunk(
    x: torch.Tensor,      # (B, C, H, P): C tokens per sequence
    dt: torch.Tensor,     # (B, C, H) f32; dt == 0 marks padding (no-op)
    A: torch.Tensor,      # (H,)
    B_: torch.Tensor,     # (B, C, G, N)
    C: torch.Tensor,      # (B, C, G, N)
    state: torch.Tensor,  # (B, H, P, N) f32: carried recurrent state
    *,
    chunk: int = 64,
    out: Optional[torch.Tensor] = None,   # (B, H, P, N) f32, may be state
):
    """The serving scan: C tokens against the carried state, decode being
    the C = 1 call.  Returns (y (B,C,H,P), new state (B,H,P,N) f32); the
    new state is written into ``out`` where one is given."""
    return _ssd("ssd_prefill_chunk", x, dt, A, B_, C, chunk, state, out)


# ---------------------------------------------------------------------------
# the Caffe blocks (``repro/kernels/ops.py:131-358``)
# ---------------------------------------------------------------------------

def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if needs_grad(x) and use_hopper(x):
        return ReluFn.apply(x, negative_slope)
    return dispatch("relu", x)(x, negative_slope)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    return dispatch("im2col", x)(x, kh, kw, stride, pad)


def col2im(cols: torch.Tensor, x_shape, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """The adjoint of ``im2col``, (N, C*KH*KW, OH*OW) -> ``x_shape``: the
    kernel at stride 1, the plain scatter at any other stride (JAX's
    ``col2im``, ``repro/kernels/ops.py:172-175``)."""
    if stride == 1:
        return dispatch("col2im", cols)(cols, x_shape, kh, kw, stride, pad)
    return ref.col2im(cols, x_shape, kh, kw, stride, pad)


def conv2d_hopper(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """conv2d's hopper lowering, ``_conv2d_fwd_impl`` of
    ``repro/kernels/ops.py:183-197``: the im2col kernel, written straight
    into the (C*KH*KW, N*OH*OW) layout of one GEMM with the batch
    flattened into its columns, then the gemm kernel ``(F, C*KH*KW) x
    (C*KH*KW, N*OH*OW)``, then the bias added in plain torch (jnp in JAX)
    while the (F, N, OH*OW) product is copied out to (N, F, OH*OW)."""
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh = ref.conv_out_size(h, kh, stride, pad)
    ow = ref.conv_out_size(wd, kw, stride, pad)
    cols = im2col_hopper(x, kh, kw, stride, pad, batch_in_columns=True)
    prod = gemm(w.reshape(f, -1), cols).view(f, n, oh * ow).transpose(0, 1)
    y = torch.empty((n, f, oh * ow), dtype=x.dtype, device=x.device)
    if b is None:
        y.copy_(prod)
    else:
        torch.add(prod, b[None, :, None], out=y)
    return y.view(n, f, oh, ow)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """x (N,C,H,W), w (F,C,KH,KW), b (F,) -> (N,F,OH,OW)."""
    if needs_grad(x, w, b) and use_hopper(x):
        return Conv2dFn.apply(x, w, b, stride, pad)
    return dispatch("conv2d", x)(x, w, b, stride=stride, pad=pad)


def conv2d_direct(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """The direct convolution, x (N,C,H,W), w (F,C,KH,KW), b (F,) ->
    (N,F,OH,OW), by the policy: the kernel on the hopper lowering (no
    backward: under grad it raises, as JAX's kernel has no VJP), else
    ``ref.conv2d`` (torch autograd of the plain version)."""
    return dispatch("conv2d_direct", x)(x, w, b, stride=stride, pad=pad)


def maxpool_with_argmax(x: torch.Tensor, k: int, stride: int,
                        pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pool evaluation returning ``(out, argmax)`` (the Caffe Pooling
    layer keeps the argmax for its backward); the argmax indexes the
    padded plane.  Differentiable in ``out`` on both lowerings
    (``MaxPoolFn``)."""
    if needs_grad(x):
        return MaxPoolFn.apply(x, k, stride, pad, use_hopper(x))
    return dispatch("maxpool", x)(x, k, stride, pad)


def maxpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> torch.Tensor:
    return maxpool_with_argmax(x, k, stride, pad)[0]


def avgpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> torch.Tensor:
    """Reference-only, as in JAX: the plain version on either backend;
    under grad through ``AvgPoolFn`` where ``avgpool_plan`` names
    "gather", else torch autograd of the plain version."""
    if needs_grad(x) and avgpool_plan(k, stride, pad, *x.shape[-2:]) \
            == "gather":
        return AvgPoolFn.apply(x, k, stride, pad)
    return ref.avgpool(x, k, stride, pad)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The kernel over the last axis; another axis takes the plain
    version, as in JAX.  The hopper lowering is not differentiable (JAX's
    ``softmax_pallas`` has no VJP): under grad its wrapper raises
    (``guard_grad``); the reference lowering is torch autograd of the
    plain version."""
    if dim in (-1, x.dim() - 1):
        return dispatch("softmax", x)(x)
    return ref.softmax(x, dim)


def softmax_xent_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the B rows (f32 scalar); labels int (B,).  A label
    outside [0, V) contributes 0 on both lowerings (``ref.softmax_xent``
    states the rule) and gets the gradient ``p / B`` (``XentFn``)."""
    if needs_grad(logits):
        return XentFn.apply(logits, labels, use_hopper(logits))
    return dispatch("softmax_xent", logits)(logits, labels)[0]


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             top_k: int = 1) -> torch.Tensor:
    """Reference-only, as in JAX."""
    return ref.accuracy(logits, labels, top_k)


register_op("matmul", reference=ref.gemm, hopper=gemm,
            doc="skinny streaming GEMM (NN / NT by strides)")
register_op("bias_add_rows", reference=ref.bias_add_rows,
            hopper=bias_add_rows_hopper, doc="matrixPlusVectorRows functor")
register_op("rmsnorm", reference=ref.rmsnorm, hopper=rmsnorm_hopper,
            doc="row RMSNorm, f32 statistics")
register_op("layernorm", reference=ref.layernorm,
            doc="LayerNorm (reference only)")
register_op("attention_decode", reference=ref.attention_decode,
            hopper=FA.flash_decode, doc="contiguous-cache decode attention")
register_op("attention_decode_paged", reference=ref.attention_decode_paged,
            hopper=FA.flash_decode_paged,
            doc="block-table paged decode attention")
register_op("attention_prefill_chunk", reference=ref.attention_prefill_chunk,
            hopper=FA.flash_prefill_chunk,
            doc="chunked-prefill attention (C-token query block vs cache)")
register_op("attention_prefill_chunk_paged",
            reference=ref.attention_prefill_chunk_paged,
            hopper=FA.flash_prefill_chunk_paged,
            doc="block-table paged chunked-prefill attention")
register_op("attention_decode_paged_quant",
            reference=ref.attention_decode_paged_quant,
            hopper=FA.flash_decode_paged_quant,
            doc="int8 paged decode attention (in-kernel per-page dequant)")
register_op("attention_prefill_chunk_paged_quant",
            reference=ref.attention_prefill_chunk_paged_quant,
            hopper=FA.flash_prefill_chunk_paged_quant,
            doc="int8 paged chunked-prefill attention (in-kernel dequant)")
register_op("attention", reference=ref.mha_attention,
            hopper=FA.flash_attention, doc="GQA flash attention (fwd + lse)")
register_op("ssd_scan", reference=ref.ssd_scan, hopper=ssd_scan_hopper,
            doc="Mamba-2 SSD chunked scan")
register_op("ssd_prefill_chunk", reference=ref.ssd_scan,
            hopper=ssd_scan_hopper,
            doc="chunked-SSD serving scan (C-token chunk vs carried state; "
                "decode is the C=1 case)")
register_op("relu", reference=ref.relu, hopper=relu_hopper,
            doc="leaky-capable ReLU")
register_op("im2col", reference=ref.im2col, hopper=im2col_hopper,
            doc="merged penta-loop im2col")
register_op("col2im", reference=ref.col2im, hopper=col2im_hopper,
            doc="im2col's adjoint (gather form, stride 1)")
register_op("conv2d", reference=ref.conv2d, hopper=conv2d_hopper,
            doc="im2col+GEMM convolution")
register_op("conv2d_direct", reference=ref.conv2d,
            hopper=conv2d_direct_hopper,
            doc="fused direct conv (implicit GEMM; beyond-paper)")
register_op("maxpool", reference=ref.maxpool, hopper=maxpool_hopper,
            doc="argmax-tracking maxpool")
register_op("avgpool", reference=ref.avgpool,
            doc="average pool (reference only)")
register_op("softmax", reference=ref.softmax, hopper=SX.softmax,
            doc="row softmax")
register_op("softmax_xent", reference=ref.softmax_xent,
            hopper=SX.softmax_xent, doc="fused softmax+NLL")
register_op("accuracy", reference=ref.accuracy,
            doc="top-k accuracy (reference only)")
