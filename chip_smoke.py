#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit, no result line):

1. device   — CUDA present, sm_90; prints nvidia-smi's name and power limit.
2. build    — compiles every ``csrc/*.cu`` kernel with nvcc for sm_90a.
3. kernels  — each kernel against its plain PyTorch version at the main
              paths' shapes (bf16 and f32), with CUDA-event timings of the
              kernel, the plain version and one library call as yardstick;
              an all-unmapped paged row must come out as zeros.
4. serving  — full-width qwen2.5-3b (36 layers, bf16, seeded random weights
              with non-zero biases) through the port's ServingEngine on the
              hopper backend, three times: the paged pool with chunked
              prefill (C = 16), the contiguous slab token by token, and the
              contiguous slab with chunked prefill.  The prefill and decode
              loops run under ``torch.cuda.set_sync_debug_mode("error")``;
              launch counts must be 253 / 73 / 108 per prefill and per
              decode step, plus 36 of the layout's chunk kernel per prefill
              step and 36 of its decode kernel per decode step; the first
              steps' logits are held against the reference backend.
5. f32      — full width at 2 layers in f32: hopper and reference token
              streams must be identical for {contiguous, paged} x
              {prefill chunk 1, 16}.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B = 4                      # decode batch of the serving phase
SEED = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # ---------------------------------------------------------------- 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need sm_90, found sm_{cap[0]}{cap[1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    # IEEE f32 on both sides of every f32 comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    secs = time.perf_counter() - t0
    print(f"[2 build] {len(_build.sources())} sources -> "
          f"{_build.library_path().name} in {secs:.1f} s", flush=True)

    # ---------------------------------------------------------------- 3
    kernels = phase_kernels(torch)

    # ---------------------------------------------------------------- 4
    launches = phase_serving(torch)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise SystemExit(f"chip_smoke: {k['name']} never launched on "
                             "a serving path")

    # ---------------------------------------------------------------- 5
    phase_f32(torch)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median of per-launch CUDA-event times.  Before every launch a 1 GiB
    buffer is zeroed: it flushes the 50 MB L2 (the decode path reads each
    weight once per step), and its ~0.3 ms on the card covers the host's
    launch overhead, so the events time the kernel and not the host."""

    def __init__(self, torch, reps: int = 25, warm: int = 3):
        self.torch = torch
        self.reps, self.warm = reps, warm
        self.flush = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warm):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.reps)]
        for s, e in pairs:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work: bytes over HBM rate vs ops over the peak
    rate of the type; returns (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------

def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.eltwise import bias_add_rows
    from repro_torch.kernels.flash_attention import (
        flash_decode,
        flash_decode_paged,
        flash_prefill_chunk,
        flash_prefill_chunk_paged,
    )
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import rmsnorm

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def check(name, got, want, tol_rel):
        """max |got - want| <= tol_rel * max |want|."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not (np.isfinite(err) and err <= tol_rel * scale):
            raise SystemExit(f"chip_smoke: {name}: max_abs_err {err:.3g} > "
                             f"{tol_rel:g} x max|ref| {scale:.3g}")
        return err

    # bf16 tolerance: one bf16 ulp at the largest magnitude (both sides
    # round the same f32 value; a different summation order moves it by at
    # most one rounding step).  The attention kernels round p to bf16 only
    # in the plain version: two ulps.  f32: summation order over K terms.
    attn = ("flash_decode", "flash_decode_paged", "flash_prefill_chunk",
            "flash_prefill_chunk_paged")
    TOL = {("bfloat16", "gemm"): 2 ** -7, ("bfloat16", "rmsnorm"): 2 ** -7,
           ("bfloat16", "bias_add_rows"): 0.0,
           ("float32", "gemm"): 1e-5, ("float32", "rmsnorm"): 1e-6,
           ("float32", "bias_add_rows"): 0.0}
    TOL.update({("bfloat16", n): 2 ** -6 for n in attn})
    TOL.update({("float32", n): 1e-5 for n in attn})
    cfg_d, d_ff, vocab = 2048, 11008, 151936
    rows = []          # one per (kernel, case)

    def run(kernel, case, dtype, step, count, kfn, pfn, lfn, nbytes, flops):
        """``count``: launches of this case in one bf16 ``step``
        ("decode" or "prefill") of the serving phase at B = 4."""
        name = kernel.__name__
        err = check(f"{name} {case} {dtype}", kfn(), pfn(),
                    TOL[(str(dtype).split(".")[1], name)])
        dt = str(dtype).split(".")[1]
        ms, p_ms = timer(kfn), timer(pfn)
        l_ms = timer(lfn) if lfn is not None else None
        b_ms, by = bound_ms(nbytes, flops, dt)
        rows.append(dict(name=name, case=case, dtype=dt, step=step,
                         count=count, err=err, ms=ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=by))
        lib = f"{l_ms:.4f}" if l_ms is not None else "n/a"
        print(f"[3 kernels] {name:25s} {case:44s} {dt:8s} {step:7s} "
              f"x{count:<3d} {ms:.4f} ms  bound {b_ms:.4f} ms ({by})  plain "
              f"{p_ms:.4f} ms  library {lib} ms  max_abs_err {err:.3g}",
              flush=True)

    hq, hkv, hd, smax, page, c = 16, 2, 128, 128, 16, 16
    lens_l = [96, 64, 40, 17]
    # the chunk cases: the last chunk of each row's prompt, ending at the
    # decode lengths -- two full chunks, a partial one and a width-1 row
    start_l, width_l = [80, 48, 32, 16], [16, 16, 8, 1]
    maxb = smax // page
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        a = rnd((B, cfg_d), dtype)
        h = rnd((B, d_ff), dtype)
        a64 = rnd((B * c, cfg_d), dtype)
        h64 = rnd((B * c, d_ff), dtype)
        w_qo = rnd((cfg_d, cfg_d), dtype, cfg_d ** -0.5)
        w_kv = rnd((cfg_d, 256), dtype, cfg_d ** -0.5)
        w_gi = rnd((cfg_d, d_ff), dtype, cfg_d ** -0.5)
        w_o = rnd((d_ff, cfg_d), dtype, d_ff ** -0.5)
        # (case, a, b, step, count per step); weights at init scale
        gemms = [
            ("wq,wo 4x2048 @ 2048x2048", a, w_qo, "decode", 36 * 2),
            ("wk,wv 4x2048 @ 2048x256", a, w_kv, "decode", 36 * 2),
            ("wg,wi 4x2048 @ 2048x11008", a, w_gi, "decode", 36 * 2),
            ("wo 4x11008 @ 11008x2048", h, w_o, "decode", 36),
            ("head 4x2048 @ embed.T (NT)", a,
             rnd((vocab, cfg_d), dtype, 0.02).T, "decode", 1),
            # the chunk's projections: M = B * C = 64 rows
            ("wq,wo 64x2048 @ 2048x2048", a64, w_qo, "prefill", 36 * 2),
            ("wk,wv 64x2048 @ 2048x256", a64, w_kv, "prefill", 36 * 2),
            ("wg,wi 64x2048 @ 2048x11008", a64, w_gi, "prefill", 36 * 2),
            ("wo 64x11008 @ 11008x2048", h64, w_o, "prefill", 36),
        ]
        for case, x, w, step, count in gemms:
            m, k = x.shape
            n = w.shape[1]
            run(gemm, case, dtype, step, count,
                lambda x=x, w=w: gemm(x, w), lambda x=x, w=w: ref.gemm(x, w),
                lambda x=x, w=w: torch.matmul(x, w),
                (m * k + k * n + m * n) * es, 2.0 * m * n * k)
        del gemms, w_qo, w_kv, w_gi, w_o
        wn = (1 + 0.1 * rnd((cfg_d,), torch.float32)).to(dtype)
        run(rmsnorm, "4x2048", dtype, "decode", 73,
            lambda: rmsnorm(a, wn), lambda: ref.rmsnorm(a, wn),
            lambda: F.rms_norm(a, (cfg_d,), wn, 1e-6),
            (2 * B * cfg_d + cfg_d) * es, 4.0 * B * cfg_d)
        for n, count in ((2048, 36), (256, 72)):
            mm, v = rnd((B, n), dtype), rnd((n,), dtype, 0.1)
            run(bias_add_rows, f"4x{n} + {n}", dtype, "decode", count,
                lambda mm=mm, v=v: bias_add_rows(mm, v),
                lambda mm=mm, v=v: ref.bias_add_rows(mm, v),
                lambda mm=mm, v=v: mm + v,
                (2 * B * n + n) * es, 1.0 * B * n)

        # -- attention: the contiguous cache and a shuffled page pool that
        # holds the same keys (every block below a row's length mapped)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
        width = torch.tensor(width_l, dtype=torch.int32, device="cuda")
        q = rnd((B, hq, hd), dtype)
        qc = rnd((B, c, hq, hd), dtype)
        kc, vc = rnd((B, smax, hkv, hd), dtype), rnd((B, smax, hkv, hd), dtype)
        n_pages = 2 * B * maxb
        ids = torch.randperm(n_pages, generator=gen, device="cuda").int()
        bt = torch.full((B, maxb), -1, dtype=torch.int32, device="cuda")
        kp = rnd((n_pages + 1, page, hkv, hd), dtype)
        vp = rnd((n_pages + 1, page, hkv, hd), dtype)
        at = 0
        for i, n in enumerate(lens_l):
            nb = -(-n // page)
            bt[i, :nb] = ids[at: at + nb]
            at += nb
        # the library yardstick reads a contiguous copy of the pages: the
        # gather runs once, outside the timed call
        kg = ref._gather_pages(kp, bt, B).transpose(1, 2)
        vg = ref._gather_pages(vp, bt, B).transpose(1, 2)
        kpos = torch.arange(smax, device="cuda")
        qpos = start[:, None] + torch.minimum(
            torch.arange(c, device="cuda")[None, :], width[:, None] - 1)
        qs, qcs = q[:, :, None, :], qc.transpose(1, 2)
        ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
        bt_bytes = B * maxb * 4
        for window in (None, 32):
            dmask = kpos[None, :] < lens[:, None]
            cmask = kpos[None, None, :] <= qpos[:, :, None]
            if window is not None:
                dmask = dmask & (kpos[None, :] >= lens[:, None] - window)
                cmask = cmask & (kpos[None, None, :]
                                 > qpos[:, :, None] - window)
            dmask, cmask = dmask[:, None, None, :], cmask[:, None, :, :]
            win = f" win {window}" if window else ""
            count = 36 if window is None else 0
            # decode: every live key read once
            keys = sum(n if window is None else min(n, window)
                       for n in lens_l)
            dbytes = (2 * B * hq * hd + 2 * keys * hkv * hd) * es
            dflops = 4.0 * keys * hq * hd
            run(flash_decode, f"q 4x16x128, cache 4x128x2x128{win}", dtype,
                "decode", count,
                lambda w=window: flash_decode(q, kc, vc, lens, window=w),
                lambda w=window: ref.attention_decode(q, kc, vc, lens,
                                                      window=w),
                lambda m_=dmask: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=m_, enable_gqa=True),
                dbytes, dflops)
            run(flash_decode_paged,
                f"q 4x16x128, pool {n_pages}+1x16x2x128{win}", dtype,
                "decode", count,
                lambda w=window: flash_decode_paged(q, kp, vp, lens, bt,
                                                    window=w),
                lambda w=window: ref.attention_decode_paged(q, kp, vp, lens,
                                                            bt, window=w),
                lambda m_=dmask: F.scaled_dot_product_attention(
                    qs, kg, vg, attn_mask=m_, enable_gqa=True),
                dbytes + bt_bytes, dflops)
            # chunk: the keys the tile union needs, once; every query row
            # (padding rows alias the last real one) over its valid keys
            ckeys = sum(s0 + w0 - (0 if window is None
                                   else max(0, s0 - window + 1))
                        for s0, w0 in zip(start_l, width_l))
            nvalid = cmask.sum().item()
            cbytes = (2 * B * c * hq * hd + 2 * ckeys * hkv * hd) * es
            cflops = 4.0 * nvalid * hq * hd
            run(flash_prefill_chunk, f"q 4x16x16x128, cache 4x128x2x128{win}",
                dtype, "prefill", count,
                lambda w=window: flash_prefill_chunk(qc, kc, vc, start, width,
                                                     window=w),
                lambda w=window: ref.attention_prefill_chunk(
                    qc, kc, vc, start, width, window=w),
                lambda m_=cmask: F.scaled_dot_product_attention(
                    qcs, ks, vs, attn_mask=m_, enable_gqa=True),
                cbytes, cflops)
            run(flash_prefill_chunk_paged,
                f"q 4x16x16x128, pool {n_pages}+1x16x2x128{win}", dtype,
                "prefill", count,
                lambda w=window: flash_prefill_chunk_paged(
                    qc, kp, vp, start, width, bt, window=w),
                lambda w=window: ref.attention_prefill_chunk_paged(
                    qc, kp, vp, start, width, bt, window=w),
                lambda m_=cmask: F.scaled_dot_product_attention(
                    qcs, kg, vg, attn_mask=m_, enable_gqa=True),
                cbytes + bt_bytes, cflops)
        # a row whose pages are all unmapped (a released row) returns zeros
        bt_u = bt.clone()
        bt_u[B - 1] = -1
        for name, fn in (
                ("flash_decode_paged",
                 lambda t: flash_decode_paged(q, kp, vp, lens, t)),
                ("flash_prefill_chunk_paged",
                 lambda t: flash_prefill_chunk_paged(qc, kp, vp, start,
                                                     width, t))):
            got, full = fn(bt_u), fn(bt)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and not got[B - 1].any()
                    and torch.equal(got[: B - 1], full[: B - 1])):
                raise SystemExit(f"chip_smoke: {name}: an all-unmapped row "
                                 "is not zeros, or it moved the other rows")
        print(f"[3 kernels] all-unmapped row: zeros from both paged kernels "
              f"({dtype})", flush=True)
        del kc, vc, kp, vp, kg, vg
        torch.cuda.empty_cache()

    # per-kernel totals over one bf16 step at B = 4: a decode step for the
    # decode-path kernels, a prefill step (C = 16) for the chunk kernels
    sources = {
        "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
                 "src/repro/kernels/gemm.py:52", "decode"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:29", "decode"),
        "bias_add_rows": ("src/repro_torch/kernels/csrc/eltwise.cu",
                          "src/repro/kernels/eltwise.py:98", "decode"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:459",
                         "decode"),
        "flash_decode_paged": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:547", "decode"),
        "flash_prefill_chunk": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:809", "prefill"),
        "flash_prefill_chunk_paged": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:909", "prefill"),
    }

    def totals(name, step):
        sel = [r for r in rows if r["name"] == name and r["step"] == step
               and r["dtype"] == "bfloat16" and r["count"]]
        tot = {key: sum(r[key] * r["count"] for r in sel)
               for key in ("ms", "plain_ms", "bound_ms")}
        tot["library_ms"] = (
            sum(r["library_ms"] * r["count"] for r in sel)
            if all(r["library_ms"] is not None for r in sel) else None)
        tot["bytes_ms"] = sum(r["bound_ms"] * r["count"] for r in sel
                              if r["bound_by"] == "bytes")
        return tot

    out = []
    for name, (src, tpu, step) in sources.items():
        tot = totals(name, step)
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": 0,
            "max_abs_err": max(r["err"] for r in rows if r["name"] == name),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["bound_ms"] / 2
            else "operations",
            "library_ms": tot["library_ms"],
        })
        lib = tot["library_ms"]
        print(f"[3 kernels] {name}: one bf16 {step} step at B={B}: "
              f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, library "
              f"{lib if lib is None else round(lib, 3)} ms", flush=True)
    tot = totals("gemm", "prefill")
    print(f"[3 kernels] gemm: one bf16 prefill step at M={B * c} (the "
          f"chunk's projections; the head runs at M={B}): {tot['ms']:.3f} ms"
          f" vs bound {tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f}"
          f" ms, library {tot['library_ms']:.3f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: full-width serving through the port's engine
# ---------------------------------------------------------------------------

def perturb(torch, params, seed: int) -> None:
    """Non-zero qkv biases and non-unit norm weights (the JAX init sets
    them to 0 and 1, which would leave the bias kernel and the weight
    multiply untested)."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)

    def noise(t, scale):
        return (torch.randn(t.shape, generator=gen, device=t.device)
                * scale).to(t.dtype)

    params["ln_f"] = params["ln_f"] + noise(params["ln_f"], 0.1)
    for p in params["layers"]:
        for key in ("bq", "bk", "bv"):
            p["attn"][key] = noise(p["attn"][key], 0.05)
        for blk in ("attn", "mlp"):
            p[blk]["ln"] = p[blk]["ln"] + noise(p[blk]["ln"], 0.1)


def requests(n, lo, hi, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


KERNELS = ("gemm", "rmsnorm", "bias_add_rows", "flash_decode",
           "flash_decode_paged", "flash_prefill_chunk",
           "flash_prefill_chunk_paged")
# launches per prefill step and per decode step at 36 layers: 7 projections
# and 2 norms per layer plus the head and the final norm; 3 bias adds
PER_STEP = {"gemm": 36 * 7 + 1, "rmsnorm": 36 * 2 + 1,
            "bias_add_rows": 36 * 3}
# the attention kernels of each layout: (decode step, prefill step)
ATTN = {"contiguous": ("flash_decode", "flash_prefill_chunk"),
        "paged": ("flash_decode_paged", "flash_prefill_chunk_paged")}
PAGE, CHUNK, GEN_LEN, MAX_LEN = 16, 16, 32, 128


def kernel_fns():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.eltwise import bias_add_rows
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import rmsnorm
    fns = {"gemm": gemm, "rmsnorm": rmsnorm, "bias_add_rows": bias_add_rows}
    fns.update({name: getattr(FA, name) for name in KERNELS[3:]})
    return fns


def serve_path(torch, model, params, reqs, layout, chunk):
    """Serve ``reqs`` on the hopper backend with the launch counts set to
    0 just before and read just after; the prefill and decode loops may
    not synchronise with the host.  Returns (launches, outputs)."""
    from repro_torch.core.policy import use_backend
    from repro_torch.serving import CacheConfig, EngineConfig, ServingEngine

    eng = ServingEngine(model, params, batch=B, max_len=MAX_LEN,
                        cache=CacheConfig(layout=layout, page_size=PAGE),
                        config=EngineConfig(steps_per_sync=8,
                                            prefill_chunk=chunk))
    for toks in reqs:
        eng.submit(toks, GEN_LEN)
    fns = kernel_fns()
    tag = f"[4 serving] {layout}, prefill chunk {chunk}:"
    with use_backend("hopper"):
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        t_pre = t_dec = t_harvest = 0.0
        while eng.busy():
            eng.admit()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t1 = time.perf_counter()
                eng.prefill()
                t2 = time.perf_counter()
                eng.decode()
                t3 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            eng.harvest()
            t_pre += t2 - t1
            t_dec += t3 - t2
            t_harvest += time.perf_counter() - t3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    s = eng.stats()
    pre, dec = eng.prefill_steps, eng.steps
    print(f"{tag} {len(reqs)} requests (prompts "
          f"{min(len(r) for r in reqs)}-{max(len(r) for r in reqs)}), gen "
          f"{GEN_LEN}, batch {B}: {pre} prefill + {dec} decode steps in "
          f"{wall:.2f} s = {1e3 * wall / (pre + dec):.2f} ms/step, "
          f"{s['generated_tokens'] / wall:.1f} generated tok/s, mean TTFT "
          f"{1e3 * s['mean_ttft_s']:.1f} ms", flush=True)
    # prefill() and decode() only enqueue: if the host is the bottleneck,
    # the harvest finds the device nearly done; if the device is, it waits
    print(f"{tag} host: prefill enqueue "
          f"{1e3 * t_pre / pre if pre else 0.0:.2f} ms/step, decode enqueue "
          f"{1e3 * t_dec / dec:.2f} ms/step, harvest wait "
          f"{1e3 * t_harvest / (pre + dec):.2f} ms/step", flush=True)
    if "kv_pages" in s:
        print(f"{tag} peak pages {int(s['kv_pages_peak'])} of "
              f"{int(s['kv_pages'])} "
              f"({s['kv_resident_bytes_peak'] / 2 ** 20:.1f} MiB of KV)",
              flush=True)
    print(f"{tag} launches {launches}", flush=True)
    want = {name: 0 for name in KERNELS}
    want.update({name: n * (pre + dec) for name, n in PER_STEP.items()})
    k_dec, k_pre = ATTN[layout]
    want[k_dec] = 36 * dec
    want[k_pre] = 36 * pre
    if launches != want or (chunk > 1) != (pre > 0):
        raise SystemExit(f"chip_smoke: {layout} chunk {chunk}: launches "
                         f"{launches}, expected {want} for {pre} prefill + "
                         f"{dec} decode steps")
    outs = eng.outputs
    if sorted(outs) != list(range(len(reqs))) or any(
            len(o) != GEN_LEN or o.min() < 0 or o.max() >= model.cfg.vocab_size
            for o in outs.values()):
        raise SystemExit(f"chip_smoke: {layout} chunk {chunk}: serving "
                         "outputs malformed")
    return launches, outs


def check_logits(torch, model, params, reqs, layout):
    """The first steps' logits, hopper vs reference, same inputs: one
    16-token prefill chunk then 4 decode steps (paged), or 6 decode steps
    (contiguous)."""
    from repro_torch.core.policy import use_backend

    toks = torch.as_tensor(
        np.stack([np.resize(r, CHUNK + 4) for r in reqs[:B]]), device="cuda")
    logits = {}
    for backend in ("hopper", "reference"):
        with use_backend(backend):
            if layout == "paged":
                state = model.init_decode_state(
                    B, MAX_LEN, per_row_pos=True, layout="paged",
                    page_size=PAGE)
                lg, state = model.prefill_chunk(
                    params, state, toks[:, :CHUNK],
                    torch.full((B,), CHUNK, device="cuda"))
                steps_l = [lg.float()]
                feed = toks[:, CHUNK:]
            else:
                state = model.init_decode_state(B, MAX_LEN, per_row_pos=True)
                steps_l, feed = [], toks[:, :6]
            for j in range(feed.shape[1]):
                lg, state = model.decode_step(params, state, feed[:, j])
                steps_l.append(lg.float())
            logits[backend] = torch.stack(steps_l)
    hop, refl = logits["hopper"], logits["reference"]
    err = (hop - refl).abs().max().item()
    scale = refl.abs().max().item()
    agree = (hop.argmax(-1) == refl.argmax(-1)).float().mean().item()
    print(f"[4 serving] {layout}: first {hop.shape[0]} steps' logits vs "
          f"reference: max_abs_err {err:.4g} (max|logit| {scale:.4g}), top-1 "
          f"agreement {agree:.3f}", flush=True)
    # bf16 through 36 layers: the two sides round at different places
    # (the attention kernels' p, rmsnorm's rsqrt), so hold them to 5% of
    # the scale
    if not (np.isfinite(err) and err <= 0.05 * scale):
        raise SystemExit(f"chip_smoke: {layout}: bf16 logits differ by "
                         f"{err:.4g}")


def phase_serving(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(SEED)
    perturb(torch, params, SEED + 1)
    torch.cuda.synchronize()
    print(f"[4 serving] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = requests(8, 16, 64, cfg.vocab_size, SEED)
    total = {name: 0 for name in KERNELS}
    streams = {}
    # the slice-2 path first, then slice 1's, then the contiguous chunk
    for layout, chunk in (("paged", CHUNK), ("contiguous", 1),
                          ("contiguous", CHUNK)):
        launches, streams[layout, chunk] = serve_path(
            torch, model, params, reqs, layout, chunk)
        for name in KERNELS:
            total[name] += launches[name]
    same = sum(np.array_equal(streams["paged", CHUNK][i],
                              streams["contiguous", 1][i])
               for i in range(len(reqs)))
    print(f"[4 serving] bf16 streams, paged chunk {CHUNK} vs contiguous "
          f"token by token: {same} of {len(reqs)} identical (bf16 rounds "
          "differently per schedule; phase 5 holds f32)", flush=True)
    for layout in ("paged", "contiguous"):
        check_logits(torch, model, params, reqs, layout)
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 5: f32, IEEE on both sides: identical token streams
# ---------------------------------------------------------------------------

def phase_f32(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving import CacheConfig, EngineConfig, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init_params(SEED)
    perturb(torch, params, SEED + 1)
    reqs = requests(6, 8, 24, cfg.vocab_size, SEED + 2)
    for layout in ("contiguous", "paged"):
        for chunk in (1, CHUNK):
            streams = {}
            for backend in ("hopper", "reference"):
                with use_backend(backend):
                    eng = ServingEngine(
                        model, params, batch=B, max_len=64,
                        cache=CacheConfig(layout=layout, page_size=PAGE),
                        config=EngineConfig(steps_per_sync=4,
                                            prefill_chunk=chunk))
                    for toks in reqs:
                        eng.submit(toks, 16)
                    streams[backend] = eng.run()
            same = all(np.array_equal(streams["hopper"][i],
                                      streams["reference"][i])
                       for i in range(len(reqs)))
            print(f"[5 f32] 2 layers at full width, {layout}, prefill chunk "
                  f"{chunk}, {len(reqs)} requests x 16 tokens: hopper == "
                  f"reference token streams: {same}", flush=True)
            if not same:
                raise SystemExit(f"chip_smoke: f32 token streams differ "
                                 f"({layout}, chunk {chunk})")


if __name__ == "__main__":
    sys.exit(main())
