"""Plain PyTorch versions of the ported kernels.

Each function computes what its Hopper kernel computes, with the JAX
package's arithmetic (``repro.kernels.ref`` / the Pallas kernel bodies):
the CPU tests hold these against the JAX oracles, and on the card the
kernels are held against these.  Nothing on the main path calls them when
a card is present unless the ``reference`` backend is asked for.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _rows(x, b: int, device: torch.device) -> torch.Tensor:
    """A () or (B,) int argument as a (B,) int32 tensor on ``device``; a
    Python int is filled in place, so no host-to-device copy syncs."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _gather_pages(pages: torch.Tensor, block_table: torch.Tensor,
                  b: int, dtype: torch.dtype = None) -> torch.Tensor:
    """Each row's pages as a logical (B, max_blocks*page, Hkv, D) cache.
    Unmapped blocks (-1) gather page 0; readers mask them by position.
    A pool narrower than the queries (bf16 under f32) is read at the
    queries' ``dtype``, as the kernels upcast each K/V tile: the pool's
    dtype is storage only, and p and the output stay f32 (JAX's oracle,
    written for one dtype, would round p to the pool's)."""
    bt = block_table.clamp(0, pages.shape[0] - 1).long()
    out = pages[bt].reshape(b, -1, *pages.shape[2:])
    if dtype == torch.float32 and pages.dtype == torch.bfloat16:
        out = out.float()
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M,K) @ (K,N) with f32 accumulation, output in ``out_dtype``
    (default ``a.dtype``)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def bias_add_rows(m: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """The paper's matrixPlusVectorRows functor: m[i,:] + vec."""
    return m + vec[None, :]


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm in f32, cast to ``x.dtype``, then the weight multiply
    (the order of ``repro/kernels/rmsnorm.py:25``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RMSNorm backward of ``repro/kernels/rmsnorm.py:56-71``, all
    statistics in f32: ``dxhat = dy * w``, ``dx = inv * (dxhat - xhat *
    mean(dxhat * xhat))``, ``dw = sum(dy * xhat)`` over the rows.  Returns
    (dx in ``x.dtype``, dw in ``w.dtype``)."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    dxhat = dyf * w.float()
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm (``repro/kernels/ref.py:444-452``): mean and variance
    in f32, the normalised value cast to ``x.dtype``, then ``* w + b``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query row per sequence against a (B,Smax,Hkv,D) cache
    (``repro/kernels/ops.py:_attention_decode_ref``)."""
    b, hq, d = q.shape
    smax = k_cache.shape[1]
    # per-row valid lengths (continuous batching: rows at different depths)
    lens = _rows(cache_len, b, q.device)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] < lens[:, None]                    # (B, Smax)
    if window is not None:
        mask &= kpos[None, :] >= lens[:, None] - window
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * (
        scale if scale is not None else 1.0 / math.sqrt(d)
    )
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, d)


def attention_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, cache_len,
                           block_table: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One query row per sequence against a (P,page,Hkv,D) page pool
    through a (B,max_blocks) block table
    (``repro/kernels/ops.py:_attention_decode_paged_ref``)."""
    b = q.shape[0]
    return attention_decode(q, _gather_pages(k_pages, block_table, b,
                                             q.dtype),
                            _gather_pages(v_pages, block_table, b, q.dtype),
                            cache_len, window=window, scale=scale)


def attention_prefill_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, start, width, *,
                            window: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """C query rows per sequence against a (B,Smax,Hkv,D) cache holding
    the chunk's own K/V (``repro/kernels/ops.py:_attention_prefill_chunk_ref``).
    Query ``i`` of row ``b`` sits at ``start + min(i, width - 1)``:
    padding rows alias the last real position, so every softmax row keeps
    a finite score."""
    b, c, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    starts = _rows(start, b, q.device)
    widths = _rows(width, b, q.device)
    i = torch.arange(c, device=q.device)[None, :]
    qpos = starts[:, None] + torch.minimum(i, widths[:, None] - 1)  # (B, C)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]                 # (B,C,S)
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    qg = q.reshape(b, c, hkv, g, d)
    s = torch.einsum("bchgd,bshd->bchgs", qg.float(), k_cache.float()) * (
        scale if scale is not None else 1.0 / math.sqrt(d)
    )
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bchgs,bshd->bchgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, c, hq, d)


def attention_prefill_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor, start, width,
                                  block_table: torch.Tensor, *,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """The chunk math over the page pool
    (``repro/kernels/ops.py:_attention_prefill_chunk_paged_ref``)."""
    b = q.shape[0]
    return attention_prefill_chunk(
        q, _gather_pages(k_pages, block_table, b, q.dtype),
        _gather_pages(v_pages, block_table, b, q.dtype), start, width,
        window=window, scale=scale)


def _dequant(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """An int8 pool (P, page, Hkv, D) times its f32 per-(page, head)
    scales (P, Hkv), in f32 (the scales stay f32 end to end)."""
    return pages.float() * scales[:, None, :, None]


def attention_decode_paged_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor, cache_len,
                                 block_table: torch.Tensor, *,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Decode over an int8 pool: dequantize, then the paged plain version
    (``repro/kernels/ops.py:_attention_decode_paged_quant_ref``)."""
    return attention_decode_paged(q, _dequant(k_pages, k_scale),
                                  _dequant(v_pages, v_scale), cache_len,
                                  block_table, window=window, scale=scale)


def attention_prefill_chunk_paged_quant(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, start, width,
        block_table: torch.Tensor, *, window: Optional[int] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """The chunk math over an int8 pool: dequantize, then the paged plain
    version
    (``repro/kernels/ops.py:_attention_prefill_chunk_paged_quant_ref``)."""
    return attention_prefill_chunk_paged(
        q, _dequant(k_pages, k_scale), _dequant(v_pages, v_scale), start,
        width, block_table, window=window, scale=scale)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA attention (B,Sq,Hq,D) x (B,Sk,Hkv,D) -> (out (B,Sq,Hq,D),
    lse (B,Hq,Sq) f32), query ``i`` at position ``i``
    (``repro/kernels/ref.py:mha_attention``; the log-sum-exp of the scaled
    scores is what ``flash_attention_pallas`` returns beside ``out``)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (
        scale if scale is not None else 1.0 / math.sqrt(d)
    )
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1).reshape(b, hq, sq)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, hq, d), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``mha_attention`` from the forward's ``out`` and
    ``lse`` (``repro/kernels/flash_attention.py:184-368``): ``dd =
    rowsum(do * out)`` in f32, ``p = exp(s - lse)`` under the forward's
    mask, ``dp = do . v``, ``ds = p * (dp - dd)``; ``dq = ds . k * scale``,
    ``dk = ds^T . q * scale`` and ``dv = p^T . do``, dk and dv summed over
    the ``Hq / Hkv`` query heads of each KV head.  All products in f32.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, g, d)
    dof = do.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    dd = (dof * out.float().reshape(b, sq, hkv, g, d)).sum(-1)   # (b,q,h,g)
    dd = dd.permute(0, 2, 3, 1)[..., None]                        # (b,h,g,q,1)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    l5 = lse.float().reshape(b, hkv, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - l5), 0.0)                 # (b,h,g,q,k)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - dd)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None,
             final_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD, the chunked formulation of ``repro/kernels/ref.py:
    ssd_scan``: x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C (B,S,G,N),
    optional carried state (B,H,P,N).  The sequence is zero-padded to a
    chunk multiple (a padding position has ``dt == 0``: decay exp(0) = 1
    and no input, an exact no-op on the state); each chunk's quadratic
    term is added to its carried-state term, and the state passes from
    chunk to chunk.  Returns (y (B,S,H,P) in ``x.dtype``, final state
    (B,H,P,N) f32).  All arithmetic is f32, as in the Pallas kernel; y is
    cast once at the end, as the kernel casts it.  A ``final_state``
    (B,H,P,N) f32 receives the final state, which is then returned; it may
    be ``initial_state`` itself."""
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    pad = (-s) % chunk
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B_.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    rep = h // g
    xc = xf.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc = Bf.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = Cf.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * A.float(), dim=2)            # (b,nc,L,h)
    # exp(cum_t - cum_u) overflows for u > t: the exponent is masked to
    # -inf before the exp (exp(-inf) = 0 exactly), so neither the values
    # nor the backward (0 * exp(inf) would be NaN) see the overflow
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None],
                                  cum[:, :, :, None] - cum[:, :, None],
                                  float("-inf")))           # (b,nc,t,u,h)
    cb = torch.einsum("bclhn,bcuhn->bcluh", Cc, Bc)
    att = cb * decay * dtc[:, :, None]
    y_intra = torch.einsum("bcluh,bcuhp->bclhp", att, xc)
    chunk_decay = torch.exp(cum[:, :, -1:] - cum)           # (b,nc,L,h)
    states = torch.einsum("bclh,bclhn,bclhp->bchpn", chunk_decay * dtc, Bc,
                          xc)
    total_decay = torch.exp(cum[:, :, -1])                  # (b,nc,h)
    carry = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), device=x.device))
    prev = []
    for c in range(nc):            # state *before* each chunk
        prev.append(carry)
        carry = carry * total_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)
    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp", Cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype)
    if final_state is not None:
        carry = final_state.copy_(carry)
    return y, carry


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence, the sequential oracle of ``ssd_scan``
    (``repro/kernels/ref.py:ssd_decode_step``): x (B,H,P), dt (B,H),
    B_/C (B,G,N), state (B,H,P,N) -> (y (B,H,P) in ``x.dtype``, state)."""
    h, g = x.shape[1], B_.shape[1]
    Bh = B_.repeat_interleave(h // g, dim=1)                # (B,H,N)
    Ch = C.repeat_interleave(h // g, dim=1)
    decay = torch.exp(dt * A[None, :])
    new = (state * decay[:, :, None, None]
           + (dt[:, :, None] * x)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new, Ch)
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# The Caffe blocks (``repro/kernels/ref.py:43-273``): NCHW tensors, output
# sizes floored as JAX's (Caffe's own pooling rounds up)
# ---------------------------------------------------------------------------

def conv_out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _windows(x: torch.Tensor, k_h: int, k_w: int, stride: int, pad: int,
             value: float, window_first: bool) -> torch.Tensor:
    """Every (k_h, k_w) window of ``x`` padded by ``value``: (N, C, KH, KW,
    OH, OW), or (N, C, OH, OW, KH, KW) when ``window_first`` is False."""
    n, c, h, w = x.shape
    oh = conv_out_size(h, k_h, stride, pad)
    ow = conv_out_size(w, k_w, stride, pad)
    xp = F.pad(x, (pad, pad, pad, pad), value=value)
    dev = x.device
    rows = (torch.arange(k_h, device=dev)[:, None]
            + stride * torch.arange(oh, device=dev)[None, :])   # (KH, OH)
    cols = (torch.arange(k_w, device=dev)[:, None]
            + stride * torch.arange(ow, device=dev)[None, :])   # (KW, OW)
    if window_first:
        return xp[:, :, rows[:, None, :, None], cols[None, :, None, :]]
    return xp[:, :, rows.T[:, None, :, None], cols.T[None, :, None, :]]


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """(N,C,H,W) -> (N, C*KH*KW, OH*OW): row ``c*KH*KW + i*KW + j``,
    column ``oy*OW + ox`` holds ``x[c, oy*stride + i - pad, ox*stride + j -
    pad]``, 0 outside the image."""
    n, c = x.shape[:2]
    patches = _windows(x, kh, kw, stride, pad, 0.0, True)
    return patches.reshape(n, c * kh * kw, -1)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """x (N,C,H,W), w (F,C,KH,KW), b (F,) -> (N,F,OH,OW): im2col, then one
    f32-accumulated product per image, rounded to ``x.dtype``, then the
    bias."""
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(wd, kw, stride, pad)
    cols = im2col(x, kh, kw, stride, pad)
    out = torch.einsum("fk,nko->nfo", w.reshape(f, -1).float(),
                       cols.float()).to(x.dtype)
    if b is not None:
        out = out + b[None, :, None]
    return out.reshape(n, f, oh, ow)


def conv2d_direct(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """The direct convolution's arithmetic (``repro/kernels/
    conv_direct.py:28-46``): x (N,C,H,W), w (F,C,KH,KW), b (F,) ->
    (N,F,OH,OW) as one (F, C) x (C, OH*OW) product per (kh, kw) shift of
    the zero-padded input, accumulated in f32, the bias added in f32, and
    one cast to ``x.dtype`` at the end.  ``conv2d`` casts the product
    first and adds the bias in ``x.dtype``: the two agree in f32 and can
    differ by one rounding in bf16."""
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(wd, kw, stride, pad)
    xp = F.pad(x.float(), (pad, pad, pad, pad))
    wf = w.float()
    acc = torch.zeros((n, f, oh * ow), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, :, i:i + (oh - 1) * stride + 1:stride,
                     j:j + (ow - 1) * stride + 1:stride].reshape(n, c, -1)
            acc = acc + torch.einsum("fc,ncp->nfp", wf[:, :, i, j], win)
    if b is not None:
        acc = acc + b.float()[None, :, None]
    return acc.to(x.dtype).reshape(n, f, oh, ow)


def col2im(cols: torch.Tensor, x_shape: Tuple[int, int, int, int], kh: int,
           kw: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """The adjoint of ``im2col`` (``repro/kernels/ref.py:74-101``), any
    stride: (N, C*KH*KW, OH*OW) scatter-added back into the zero-padded
    (N, C, H+2*pad, W+2*pad) plane in ``cols.dtype``, then cropped to
    ``x_shape``."""
    n, c, h, w = x_shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    hp, wp = h + 2 * pad, w + 2 * pad
    dev = cols.device
    rows = (torch.arange(kh, device=dev)[:, None]
            + stride * torch.arange(oh, device=dev)[None, :])   # (KH, OH)
    cix = (torch.arange(kw, device=dev)[:, None]
           + stride * torch.arange(ow, device=dev)[None, :])    # (KW, OW)
    # the padded flat index of every (i, j, oy, ox) tap, in cols' row order
    idx = rows[:, None, :, None] * wp + cix[None, :, None, :]
    out = torch.zeros((n, c, hp * wp), dtype=cols.dtype, device=dev)
    out.index_add_(2, idx.reshape(-1), cols.reshape(n, c, -1))
    return out.view(n, c, hp, wp)[:, :, pad:pad + h, pad:pad + w].contiguous()


def conv2d_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
               stride: int = 1, pad: int = 0, has_bias: bool = True):
    """Gradients of ``conv2d`` with respect to (x, w, b), dy (N,F,OH,OW)
    (``repro/kernels/ref.py:130-159``): f32-accumulated products rounded
    to the operands' dtypes, ``dx`` by ``col2im``; ``db`` is None without
    a bias."""
    n, c = x.shape[:2]
    f, _, kh, kw = w.shape
    dy_mat = dy.reshape(n, f, -1).float()
    cols = im2col(x, kh, kw, stride, pad)
    dw = torch.einsum("nfo,nko->fk", dy_mat, cols.float()).to(w.dtype)
    dcols = torch.einsum("fk,nfo->nko", w.reshape(f, -1).float(),
                         dy_mat).to(x.dtype)
    dx = col2im(dcols, tuple(x.shape), kh, kw, stride, pad)
    db = dy.sum(dim=(0, 2, 3)) if has_bias else None
    return dx, dw.reshape(w.shape), db


def maxpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, argmax), both (N,C,OH,OW).  The plane is padded with
    ``finfo(x.dtype).min``; the argmax is int32 ``row*WP + col`` in the
    padded plane (WP = W + 2*pad), and the first maximum of a window in
    row-major order wins."""
    n, c, h, w = x.shape
    win = _windows(x, k, k, stride, pad, torch.finfo(x.dtype).min, False)
    oh, ow = win.shape[2], win.shape[3]
    flat = win.reshape(n, c, oh, ow, k * k)
    out, local = flat.amax(dim=-1), flat.argmax(dim=-1)
    dev = x.device
    row = stride * torch.arange(oh, device=dev)[:, None] + local // k
    col = stride * torch.arange(ow, device=dev)[None, :] + local % k
    return out, (row * (w + 2 * pad) + col).to(torch.int32)


def maxpool_bwd(dy: torch.Tensor, argmax: torch.Tensor,
                x_shape: Tuple[int, int, int, int], k: int, stride: int,
                pad: int = 0) -> torch.Tensor:
    """The backward of ``maxpool`` (``repro/kernels/ref.py:191-209``): each
    window's ``dy`` scatter-added at its stored argmax into the zero (N, C,
    H+2*pad, W+2*pad) plane in ``dy.dtype``, then cropped; a tie gives all
    of ``dy`` to the first maximum, and overlapping windows add up."""
    n, c, h, w = x_shape
    hp, wp = h + 2 * pad, w + 2 * pad
    flat = torch.zeros((n, c, hp * wp), dtype=dy.dtype, device=dy.device)
    flat.scatter_add_(2, argmax.reshape(n, c, -1).long(),
                      dy.reshape(n, c, -1))
    return flat.view(n, c, hp, wp)[:, :, pad:pad + h,
                                   pad:pad + w].contiguous()


def avgpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> torch.Tensor:
    """Mean over every k x k window of the zero-padded plane (padding
    counted, as JAX's)."""
    return _windows(x, k, k, stride, pad, 0.0, False).mean(dim=(-1, -2))


def _slope(negative_slope: float, t: torch.Tensor) -> torch.Tensor:
    """The slope in ``t``'s dtype: JAX's weakly typed ``slope * t`` rounds
    it so before the product (in bf16 at a slope bf16 cannot hold, the
    product differs)."""
    return torch.tensor(negative_slope, dtype=t.dtype)


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """Caffe's leaky-capable ReLU: ``where(x > 0, x, slope * x)``, the
    slope in ``x``'s dtype."""
    return torch.where(x > 0, x, _slope(negative_slope, x) * x)


def relu_bwd(x: torch.Tensor, dy: torch.Tensor,
             negative_slope: float = 0.0) -> torch.Tensor:
    """``where(x > 0, dy, slope * dy)``, the slope in ``dy``'s dtype: a
    NaN in ``x`` takes the slope."""
    return torch.where(x > 0, dy, _slope(negative_slope, dy) * dy)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax in f32, ``e / sum(e)``, cast to ``x.dtype``
    (``repro/kernels/softmax_xent.py:27-32``)."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=dim, keepdim=True))
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,V) logits, (B,) int labels -> (mean NLL f32, probs in the logits'
    dtype), f32 inside: ``logp = (x - max) - lse``, ``probs = exp(logp)``
    (``repro/kernels/softmax_xent.py:62-75``).  A label outside [0, V)
    matches no class, so its row's NLL is 0, and the mean still divides
    by B: the rule of JAX's Pallas kernel, whose one-hot never matches
    such a label (JAX's oracle wraps -1 to the last class instead)."""
    v = logits.shape[-1]
    x = logits.float()
    s = x - x.amax(dim=-1, keepdim=True)
    logp = s - torch.log(torch.exp(s).sum(dim=-1, keepdim=True))
    lab = labels.long()
    valid = (lab >= 0) & (lab < v)
    picked = logp.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    nll = torch.where(valid, -picked, torch.zeros_like(picked))
    return nll.mean(), torch.exp(logp).to(logits.dtype)


def softmax_xent_bwd(probs: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """The gradient of ``softmax_xent``'s mean NLL with respect to the
    logits, ``(p - onehot) / B`` in ``probs.dtype``
    (``repro/kernels/ref.py:263-266``).  A label outside [0, V) has no
    one-hot (``jax.nn.one_hot``), so its row gets ``p / B``."""
    b, v = probs.shape
    onehot = labels.long()[:, None] == torch.arange(v, device=probs.device)
    return (probs - onehot.to(probs.dtype)) / b


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             top_k: int = 1) -> torch.Tensor:
    """The share of rows whose label is among the ``top_k`` largest logits
    (f32).  Ties rank the lower class first, as ``argmax`` and
    ``jax.lax.top_k`` do."""
    if top_k == 1:
        hit = logits.argmax(dim=-1) == labels
    else:
        idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :top_k]
        hit = (idx == labels[:, None]).any(dim=-1)
    return hit.float().mean()
