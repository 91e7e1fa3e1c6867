"""Portable ops — the backend-switched, differentiable operator set the
model calls.

Every op is registered once in ``repro_torch.core.registry`` with its two
lowerings — the plain PyTorch version (``kernels/ref.py``) and the Hopper
kernel wrapper — and exposed as a plain function; the policy
(``repro_torch.core.policy``) decides per call from the backend and the
tensor's device which one runs.  Registered so far: the ops of the
contiguous and paged (and int8 paged) decode paths, of chunked prefill,
of the Mamba-2 blocks, of the full forward and of the Caffe layers'
forwards (``relu``, ``im2col``, ``conv2d``, ``maxpool``, ``softmax``,
``softmax_xent`` with both lowerings; ``avgpool`` and ``accuracy``
reference-only, as in JAX); ``col2im``, ``conv2d_direct`` and
``layernorm`` come with later slices.

Differentiation mirrors ``repro.kernels.ops``.  When grad mode is on and
an input requires grad, the ops of the training forward go through
autograd: the reference lowering is torch autograd of the plain version
(``matmul`` through a Function whose backward is ``_matmul_r_bwd``'s: the
cotangent cast to the operand's dtype, two f32-accumulated products); the
hopper lowering is an ``autograd.Function`` per op whose forward launches
the kernel and whose backward launches the backward kernels where the TPU
port has them (``matmul``: two more gemms; ``rmsnorm``: ``rmsnorm_bwd``;
``attention``: ``flash_attention_bwd`` from the saved out and lse) and is
plain PyTorch where JAX's is jnp (``bias_add_rows``: ``(g, g.sum(0))``;
``ssd_scan``: the vjp of the plain version, as JAX has no SSD backward
kernel either).  A kernel wrapper called outside these Functions on a
tensor that requires grad raises (``_build.guard_grad``) rather than cut
the graph.  The serving ops (decode, chunked prefill) are not
differentiable, and neither are the Caffe ops' hopper lowerings yet: their
backward kernels come with the Caffe training slice, so under grad they
raise through ``guard_grad`` (the reference lowerings are torch autograd
of the plain versions).
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
from repro_torch.kernels.eltwise import bias_add_rows as bias_add_rows_hopper
from repro_torch.kernels.eltwise import relu as relu_hopper
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.im2col import im2col as im2col_hopper
from repro_torch.kernels.mamba_scan import ssd_scan as ssd_scan_hopper
from repro_torch.kernels.pooling import maxpool as maxpool_hopper
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
    return dispatch("relu", x)(x, negative_slope)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    return dispatch("im2col", x)(x, kh, kw, stride, pad)


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
    return dispatch("conv2d", x)(x, w, b, stride=stride, pad=pad)


def maxpool_with_argmax(x: torch.Tensor, k: int, stride: int,
                        pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pool evaluation returning ``(out, argmax)`` (the Caffe Pooling
    layer keeps the argmax for its backward); the argmax indexes the
    padded plane."""
    return dispatch("maxpool", x)(x, k, stride, pad)


def maxpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> torch.Tensor:
    return maxpool_with_argmax(x, k, stride, pad)[0]


def avgpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> torch.Tensor:
    """Reference-only, as in JAX."""
    return ref.avgpool(x, k, stride, pad)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The kernel over the last axis; another axis takes the plain
    version, as in JAX."""
    if dim in (-1, x.dim() - 1):
        return dispatch("softmax", x)(x)
    return ref.softmax(x, dim)


def softmax_xent_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the B rows (f32 scalar); labels int (B,).  A label
    outside [0, V) contributes 0 on both lowerings (``ref.softmax_xent``
    states the rule)."""
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
register_op("conv2d", reference=ref.conv2d, hopper=conv2d_hopper,
            doc="im2col+GEMM convolution")
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
