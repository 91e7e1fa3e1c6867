#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit, no result line):

1. device   — CUDA present, sm_90; prints nvidia-smi's name and power limit.
2. build    — compiles every ``csrc/*.cu`` kernel with nvcc for sm_90a.
3. kernels  — each kernel against its plain PyTorch version at the main
              path's shapes (bf16 and f32), with CUDA-event timings of the
              kernel, the plain version and one library call as yardstick.
4. serving  — full-width qwen2.5-3b (36 layers, bf16, seeded random weights
              with non-zero biases) through the port's ServingEngine on the
              hopper backend; the fused decode loop runs under
              ``torch.cuda.set_sync_debug_mode("error")``; launch counts
              must be 253 / 73 / 108 / 36 per decode step; the first
              steps' logits are held against the reference backend.
5. f32      — full width at 2 layers in f32: hopper and reference token
              streams must be identical.

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
    from repro_torch.kernels.flash_attention import flash_decode
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
    # most one rounding step).  flash_decode rounds p to bf16 only in the
    # plain version: two ulps.  f32: summation order over K terms.
    TOL = {("bfloat16", "gemm"): 2 ** -7, ("bfloat16", "rmsnorm"): 2 ** -7,
           ("bfloat16", "bias_add_rows"): 0.0,
           ("bfloat16", "flash_decode"): 2 ** -6,
           ("float32", "gemm"): 1e-5, ("float32", "rmsnorm"): 1e-6,
           ("float32", "bias_add_rows"): 0.0,
           ("float32", "flash_decode"): 1e-5}
    cfg_d, d_ff, vocab = 2048, 11008, 151936
    rows = []          # one per (kernel, case)

    def run(kernel, case, dtype, count, kfn, pfn, lfn, nbytes, flops):
        name = kernel.__name__
        err = check(f"{name} {case} {dtype}", kfn(), pfn(),
                    TOL[(str(dtype).split(".")[1], name)])
        dt = str(dtype).split(".")[1]
        ms, p_ms = timer(kfn), timer(pfn)
        l_ms = timer(lfn) if lfn is not None else None
        b_ms, by = bound_ms(nbytes, flops, dt)
        rows.append(dict(name=name, case=case, dtype=dt, count=count,
                         err=err, ms=ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=by))
        lib = f"{l_ms:.4f}" if l_ms is not None else "n/a"
        print(f"[3 kernels] {name:14s} {case:34s} {dt:8s} x{count:<3d} "
              f"{ms:.4f} ms  bound {b_ms:.4f} ms ({by})  plain {p_ms:.4f} ms"
              f"  library {lib} ms  max_abs_err {err:.3g}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        a = rnd((B, cfg_d), dtype)
        h = rnd((B, d_ff), dtype)
        # (case, a, b, decode-step count); weights at init scale
        gemms = [
            ("wq,wo 4x2048 @ 2048x2048", a, rnd((cfg_d, cfg_d), dtype,
                                                cfg_d ** -0.5), 36 * 2),
            ("wk,wv 4x2048 @ 2048x256", a, rnd((cfg_d, 256), dtype,
                                               cfg_d ** -0.5), 36 * 2),
            ("wg,wi 4x2048 @ 2048x11008", a, rnd((cfg_d, d_ff), dtype,
                                                 cfg_d ** -0.5), 36 * 2),
            ("wo 4x11008 @ 11008x2048", h, rnd((d_ff, cfg_d), dtype,
                                               d_ff ** -0.5), 36),
            ("head 4x2048 @ embed.T (NT)", a,
             rnd((vocab, cfg_d), dtype, 0.02).T, 1),
        ]
        for case, x, w, count in gemms:
            m, k = x.shape
            n = w.shape[1]
            run(gemm, case, dtype, count,
                lambda x=x, w=w: gemm(x, w), lambda x=x, w=w: ref.gemm(x, w),
                lambda x=x, w=w: torch.matmul(x, w),
                (m * k + k * n + m * n) * es, 2.0 * m * n * k)
        del gemms
        wn = (1 + 0.1 * rnd((cfg_d,), torch.float32)).to(dtype)
        run(rmsnorm, "4x2048", dtype, 73,
            lambda: rmsnorm(a, wn), lambda: ref.rmsnorm(a, wn),
            lambda: F.rms_norm(a, (cfg_d,), wn, 1e-6),
            (2 * B * cfg_d + cfg_d) * es, 4.0 * B * cfg_d)
        for n, count in ((2048, 36), (256, 72)):
            mm, v = rnd((B, n), dtype), rnd((n,), dtype, 0.1)
            run(bias_add_rows, f"4x{n} + {n}", dtype, count,
                lambda mm=mm, v=v: bias_add_rows(mm, v),
                lambda mm=mm, v=v: ref.bias_add_rows(mm, v),
                lambda mm=mm, v=v: mm + v,
                (2 * B * n + n) * es, 1.0 * B * n)
        hq, hkv, hd, smax = 16, 2, 128, 128
        lens_l = [96, 64, 40, 17]
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        q = rnd((B, hq, hd), dtype)
        kc, vc = rnd((B, smax, hkv, hd), dtype), rnd((B, smax, hkv, hd), dtype)
        mask = (torch.arange(smax, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        live = sum(lens_l)
        for window in (None, 32):
            wmask = mask if window is None else mask & (
                torch.arange(smax, device="cuda")[None, :]
                >= (lens[:, None] - window))[:, None, None, :]
            keys = live if window is None else sum(min(n, window)
                                                   for n in lens_l)
            run(flash_decode,
                f"q 4x16x128, cache 4x128x2x128"
                + (f" win {window}" if window else ""), dtype,
                36 if window is None else 0,
                lambda w=window: flash_decode(q, kc, vc, lens, window=w),
                lambda w=window: ref.attention_decode(q, kc, vc, lens,
                                                      window=w),
                lambda m_=wmask: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=m_, enable_gqa=True),
                (2 * B * hq * hd + 2 * keys * hkv * hd) * es,
                4.0 * keys * hq * hd)
        del kc, vc
        torch.cuda.empty_cache()

    # per-kernel totals over one bf16 decode step at B = 4
    sources = {
        "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
                 "src/repro/kernels/gemm.py:52"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:29"),
        "bias_add_rows": ("src/repro_torch/kernels/csrc/eltwise.cu",
                          "src/repro/kernels/eltwise.py:98"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:459"),
    }
    out = []
    for name, (src, tpu) in sources.items():
        sel = [r for r in rows if r["name"] == name
               and r["dtype"] == "bfloat16" and r["count"]]
        tot = {key: sum(r[key] * r["count"] for r in sel)
               for key in ("ms", "plain_ms", "bound_ms")}
        lib = (sum(r["library_ms"] * r["count"] for r in sel)
               if all(r["library_ms"] is not None for r in sel) else None)
        t_bytes = sum(r["bound_ms"] * r["count"] for r in sel
                      if r["bound_by"] == "bytes")
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": 0,
            "max_abs_err": max(r["err"] for r in rows if r["name"] == name),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= tot["bound_ms"] / 2
            else "operations",
            "library_ms": lib,
        })
        print(f"[3 kernels] {name}: one bf16 decode step at B={B}: "
              f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, library "
              f"{lib if lib is None else round(lib, 3)} ms", flush=True)
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


KERNELS = ("gemm", "rmsnorm", "bias_add_rows", "flash_decode")
PER_STEP = {"gemm": 36 * 7 + 1, "rmsnorm": 36 * 2 + 1,
            "bias_add_rows": 36 * 3, "flash_decode": 36}


def kernel_fns():
    from repro_torch.kernels.eltwise import bias_add_rows
    from repro_torch.kernels.flash_attention import flash_decode
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"gemm": gemm, "rmsnorm": rmsnorm, "bias_add_rows": bias_add_rows,
            "flash_decode": flash_decode}


def phase_serving(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, ServingEngine

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
    gen_len, max_len = 32, 128
    eng = ServingEngine(model, params, batch=B, max_len=max_len,
                        config=EngineConfig(steps_per_sync=8))
    for toks in reqs:
        eng.submit(toks, gen_len)
    fns = kernel_fns()
    with use_backend("hopper"):
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        t_enqueue = t_harvest = 0.0
        while eng.busy():
            eng.admit()
            # the fused decode loop may not synchronise with the host
            torch.cuda.set_sync_debug_mode("error")
            t1 = time.perf_counter()
            try:
                eng.decode()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            t2 = time.perf_counter()
            eng.harvest()
            t_enqueue += t2 - t1
            t_harvest += time.perf_counter() - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    s = eng.stats()
    steps = eng.steps
    print(f"[4 serving] {len(reqs)} requests (prompts "
          f"{min(len(r) for r in reqs)}-{max(len(r) for r in reqs)}), gen "
          f"{gen_len}, batch {B}: {steps} decode steps in {wall:.2f} s = "
          f"{1e3 * wall / steps:.2f} ms/step, {s['generated_tokens'] / wall:.1f}"
          f" generated tok/s, mean TTFT {1e3 * s['mean_ttft_s']:.1f} ms",
          flush=True)
    # decode() only enqueues: if the host is the bottleneck, the harvest
    # finds the device nearly done; if the device is, the harvest waits
    print(f"[4 serving] host: decode enqueue {1e3 * t_enqueue / steps:.2f} "
          f"ms/step, harvest wait {1e3 * t_harvest / steps:.2f} ms/step",
          flush=True)
    print(f"[4 serving] launches {launches} over {steps} steps", flush=True)
    for name in KERNELS:
        if launches[name] != PER_STEP[name] * steps:
            raise SystemExit(
                f"chip_smoke: {name}: {launches[name]} launches, expected "
                f"{PER_STEP[name]} x {steps} steps")
    outs = eng.outputs
    if sorted(outs) != list(range(len(reqs))) or any(
            len(o) != gen_len or o.min() < 0 or o.max() >= cfg.vocab_size
            for o in outs.values()):
        raise SystemExit("chip_smoke: serving outputs malformed")

    # the first decode steps' logits, hopper vs reference, same inputs
    first = torch.as_tensor(np.stack([r[:6] for r in reqs[:B]]),
                            device="cuda")
    logits = {}
    for backend in ("hopper", "reference"):
        with use_backend(backend):
            state = model.init_decode_state(B, max_len, per_row_pos=True)
            steps_l = []
            for j in range(first.shape[1]):
                lg, state = model.decode_step(params, state, first[:, j])
                steps_l.append(lg.float())
            logits[backend] = torch.stack(steps_l)
    hop, refl = logits["hopper"], logits["reference"]
    err = (hop - refl).abs().max().item()
    scale = refl.abs().max().item()
    agree = (hop.argmax(-1) == refl.argmax(-1)).float().mean().item()
    print(f"[4 serving] first {first.shape[1]} steps' logits vs reference: "
          f"max_abs_err {err:.4g} (max|logit| {scale:.4g}), top-1 agreement "
          f"{agree:.3f}", flush=True)
    # bf16 through 36 layers: the two sides round at different places
    # (flash_decode's p, rmsnorm's rsqrt), so hold them to 5% of the scale
    if not (np.isfinite(err) and err <= 0.05 * scale):
        raise SystemExit(f"chip_smoke: bf16 logits differ by {err:.4g}")
    del params, eng, state, logits
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: f32, IEEE on both sides: identical token streams
# ---------------------------------------------------------------------------

def phase_f32(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving import EngineConfig, ServingEngine

    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init_params(SEED)
    perturb(torch, params, SEED + 1)
    reqs = requests(6, 8, 24, cfg.vocab_size, SEED + 2)
    streams = {}
    for backend in ("hopper", "reference"):
        with use_backend(backend):
            eng = ServingEngine(model, params, batch=B, max_len=64,
                                config=EngineConfig(steps_per_sync=4))
            for toks in reqs:
                eng.submit(toks, 16)
            streams[backend] = eng.run()
    same = all(np.array_equal(streams["hopper"][i], streams["reference"][i])
               for i in range(len(reqs)))
    print(f"[5 f32] 2 layers at full width, {len(reqs)} requests x 16 tokens: "
          f"hopper == reference token streams: {same}", flush=True)
    if not same:
        raise SystemExit("chip_smoke: f32 token streams differ")


if __name__ == "__main__":
    sys.exit(main())
