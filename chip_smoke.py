#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (non-zero exit, no result line):

1. device   — CUDA present, sm_90; prints nvidia-smi's name and power limit.
2. build    — compiles every ``csrc/*.cu`` kernel with nvcc for sm_90a.
3. kernels  — each of the twenty-three kernels against its plain PyTorch
              version at the main paths' shapes (bf16 and f32; qwen2.5-3b's,
              the recurrent archs' and mixtral-8x7b's, the attention
              kernels also at glm4-9b's, deepseek-coder-33b's and
              internlm2-20b's heads (32/2, 56/8, 48/8 of 128), LeNet's
              (f32, batch 64: every im2col, gemm, bias add, maxpool and
              relu call of a LeNet-MNIST and a LeNet-CIFAR-10 forward,
              softmax_xent at 64 x 10, softmax at 64 x 10 and 256 x 1000,
              maxpool on exact ties and with a pad of 1, each Caffe
              kernel once in bf16; the Caffe backward's: every col2im,
              maxpool_bwd, relu_bwd and softmax_xent_bwd launch and every
              backward gemm of both LeNets' train steps, col2im in both
              column layouts and at pad 2, maxpool_bwd on ties with pads
              0 and 1, relu_bwd on a column-major x, softmax_xent_bwd
              with the cotangent folded in (g 1.7, labels -1 and V, 256 x
              1000, a column-major probs, a base off 16 bytes), CIFAR's
              two average-pool backwards (aten's gather against the
              window gather's autograd); conv2d_direct at the five LeNet
              convolutions, JAX's test cases, the autotuner's conv3x3
              cell, in bf16 and on a channels-last x), and the training
              step's: rmsnorm_bwd at 512 rows of 2048 and 5120 (dw the
              same bits on every call, two kernels a call, its plans
              swept),
              flash_attention_bwd at B 2 x S 256 with qwen2.5-3b's,
              zamba2-2.7b's and, windowed, mixtral-8x7b's heads and off
              those shapes (S 200 at B 1, non-causal Sk > Sq at D 64, D 72
              on the scalar route), and the gemm in every layout of the
              forward and both backward products, the tied head's
              included, and the tensor-core kernel's four layouts at
              ragged aligned shapes with and without split K, and an
              unaligned stride on the scalar route), with CUDA-event
              timings of the kernel, the plain version and one library call
              as yardstick (none for the SSD scan; the backward of
              ``F.rms_norm`` and of ``F.scaled_dot_product_attention``
              for the backward kernels; ``F.fold`` and the backward of
              ``F.max_pool2d``, ``F.leaky_relu`` and ``F.cross_entropy``
              for the Caffe backward kernels; ``F.conv2d`` and the port's
              im2col + gemm form for conv2d_direct); the int8 pools are
              filled by the pager's quantized writes, and the paged kernels
              also read a bf16 pool under f32 queries; an all-unmapped
              paged row must come out as zeros, an SSD row with no real token
              must keep its carried state bit for bit, the SSD state written
              in place must equal a new one bit for bit, grouped B/C
              must raise in the ops layer, and rmsnorm_bwd must take the
              widest row of each of its routes and raise on the next.
              rmsnorm runs at qwen2.5-3b's decode (4 rows), prefill (64)
              and train (512) rows and the recurrent archs' and
              mixtral's, bias_add_rows at qwen's 4, 64 and 512 rows of
              2048 and 256, both also at a misaligned view, a width of
              no whole vectors, rmsnorm at the widest row "vec" takes
              and the next, the bias at a row stride past N and at the
              vocabulary's width.
              The gemm, the attention backward, the attention forward,
              the three decodes (contiguous slab, bf16 pool, int8 pool),
              the three chunked prefills, rmsnorm_bwd, conv2d_direct,
              relu_bwd, maxpool, relu, ssd_scan, softmax, rmsnorm,
              bias_add_rows, im2col, col2im, softmax_xent, maxpool_bwd
              and softmax_xent_bwd have routes
              (``kernels/gemm.py:plan``,
              ``kernels/flash_attention.py:bwd_plan``, ``fwd_plan``,
              ``decode_plan``, ``chunk_plan``,
              ``kernels/rmsnorm.py:bwd_plan``, ``fwd_plan``,
              ``kernels/conv_direct.py:plan``,
              ``kernels/eltwise.py:relu_bwd_plan``, ``relu_plan``,
              ``bias_plan``,
              ``kernels/pooling.py:maxpool_plan``,
              ``kernels/mamba_scan.py:ssd_plan``,
              ``kernels/softmax_xent.py:softmax_plan``,
              ``softmax_xent_plan``, ``kernels/im2col.py:im2col_plan``,
              ``col2im_plan``, ``kernels/pooling.py:maxpool_bwd_plan``,
              ``kernels/softmax_xent.py:softmax_xent_bwd_plan``):
              each row prints the
              route its wrapper took, every bf16 training shape must take
              the tensor-core kernels, the bf16 forward the tensor-core
              kernel, every bf16 decode the split kernel, every bf16
              chunk the tensor-core chunk kernel (f32 all on the
              template, the bf16 pool under f32 queries too), the
              training step's rmsnorm_bwd the vector kernel, every 3 x 3
              and 5 x 5 stride-1 convolution the register-tiled kernel
              ("reg"; JAX's 2 x 2 and strided cases "scalar") and every
              relu_bwd whose x and dy share a layout the vector kernel
              ("vec"; a column-major x with a row-major dy "strided"),
              every LeNet maxpool (ties, pad 1 and bf16 too) the
              staged-band kernel ("plane"; a column-major x "strided")
              and every relu the vector kernel ("vec", a column-major x
              too; a view offset by one element "scalar"), every SSD
              decode the register-streaming kernel ("step") and every
              chunk and forward the head-split chunk kernel ("split"; B/C
              row strides off the 16-byte vectors "block"; a row with dt =
              0 keeps its state bit for bit on all three, the in-place
              state equals a new one on "step" and "split"), every softmax
              of unit-stride rows the register-row kernel ("rows"; a
              column-major x "strided"; a row of -inf NaN on both),
              every rmsnorm and bias of whole aligned 16-byte rows the
              vector kernels ("vec"; LeNet's N = 10 bias and the edges
              "scalar"), every softmax_xent of unit-stride rows the
              register-row kernel with the mean fused in ("rows": LeNet's
              64 x 10 loss one launch, 256 x 1000 two, as the profiler
              shows; a column-major x "strided"; labels -1 and V and a
              row of -inf on both), every maxpool_bwd of row-major dy
              and argmax at stride 2 or 3 the window-owner kernel
              ("window": MNIST's pools, ties, pad 1, a 3/3 and a 2/3
              pool, a row of no whole vectors, bf16; a column-major dy
              and a stride of 4 "pixel"), every softmax_xent_bwd of
              unit-stride probs the register-row kernel with g folded in
              ("rows": the 64 x 10 backward one launch, as the profiler
              shows; a column-major probs and a base off 16 bytes
              "strided"), each bit for bit the first kernel then torch's
              ``* g``.
              conv2d_direct's rows are also timed on the scalar kernel
              (``forced_scalar_conv``) and swept over ``tiles``' caps at
              the LeNet shapes (``grep "conv sweep"``), relu_bwd's on the
              strided kernel (``forced_strided``) and swept over
              ``relu_vec_grid``'s block caps (``grep "relu_bwd
              sweep"``), maxpool's on the strided kernel
              (``forced_strided_pool``) and swept over ``maxpool_band``'s
              caps (``grep "pool sweep"``), relu's on the scalar kernel
              (``forced_scalar_relu``) and swept over ``relu_vec_grid``'s
              block caps (``grep "relu sweep"``), ssd_scan's on the block
              kernel (``forced_block_ssd``) and swept over ``ssd_step``'s
              and ``ssd_split``'s knobs and lane layouts (``grep "ssd_scan
              step sweep"``, ``"split sweep"``), softmax's on the strided
              kernel (``forced_strided_softmax``) and swept over
              ``softmax_rows``' knobs (``grep "softmax rows sweep"``),
              rmsnorm's and bias_add_rows' on the scalar kernels
              (``forced_scalar_norm``, ``forced_scalar_bias``) and swept
              over ``fwd_rows``' and ``bias_grid``'s caps (``grep
              "rmsnorm sweep"``, ``grep "bias sweep"``), softmax_xent's
              on the strided kernel and torch's mean
              (``forced_strided_xent``) and swept over
              ``softmax_xent_rows``' knobs (``grep "softmax_xent rows
              sweep"``), maxpool_bwd's on the pixel kernel
              (``forced_pixel_pool_bwd``, bit for bit) and swept over
              ``maxpool_bwd_band``'s caps (``grep "maxpool_bwd window
              sweep"``), both beside the timer's plain write and read of
              their bytes (``grep "timer floor"``), softmax_xent_bwd's
              as the first kernel then torch's ``* g``
              (``forced_twostep_xent_bwd``, bit for bit).  The
              forward (at the --check shape and at the training shape,
              B 2 x S 256, with qwen2.5-3b's, zamba2's and, windowed,
              mixtral's heads), the three decodes and the three chunks
              (at every arch's heads, a group of 32 included) are also
              timed on the template they left (``forced_scalar``,
              ``forced_template``), rmsnorm_bwd on the scalar kernel it
              left (``forced_scalar_bwd``); each decode's split is swept over
              block targets, and each chunk's over block targets and
              warps a block, at the served archs' heads, and each routed
              wrapper's host time a call is set beside the template's and
              SDPA's.  The
              gemm's skinny kernel is also timed against its tiled
              route (tensor cores in bf16, the scalar kernel in f32) at
              qwen2.5-3b's projection and
              head shapes for M from 1 to 320: their crossover sets
              ``kernels/gemm.py``'s ``SKINNY_MAX_M`` per dtype.  The
              LeNet products on the f32 small-M route (``csrc/gemm_f32.cu``:
              the forward convolutions and inner products, dw and da) are
              also timed on the skinny kernel they left, forced as the
              crossover forces a route; the small-M kernel is also held
              at ragged M and N, the unaligned K = 25 and 75 rows, A read
              along M, an unaligned B and a split whose last slice is
              short, and timed at qwen2.5-3b's f32 decode and prefill
              products against the skinny kernel that keeps them.
4. serving  — full width, seeded random weights with perturbed biases,
              norm weights and Mamba decay/step/skip parameters, through
              the port's ServingEngine on the hopper backend: qwen2.5-3b
              (36 layers, bf16) paged with chunked prefill (C = 16), the
              contiguous slab token by token and contiguous with C = 16;
              mamba2-2.7b (64 layers) token by token and with C = 16 (it
              has no KV, so no layout); zamba2-2.7b (54 Mamba layers, the
              shared attention block 9 times) paged with C = 16 and
              contiguous token by token; qwen2.5-3b and zamba2-2.7b also
              from an int8 pool (paged, C = 16); mixtral-8x7b at 16 of its
              32 layers (its 32 do not fit in 80 GB) paged with C = 16 from
              the bf16 pool and from an int8 pool, whose resident KV bytes
              must be exactly half the bf16 pool's at the same peak pages.
              The prefill and decode loops run under
              ``torch.cuda.set_sync_debug_mode("error")``; launch counts per
              prefill and decode step are exact (``per_step`` derives them
              from the config), every bf16 decode on the split kernel,
              every bf16 chunk (the slab, a bf16 or an int8 pool) on the
              tensor-core chunk kernel, every SSD decode on "step" and
              chunk on "split" (so too in phases 5-7: the --check and
              training forwards on "split"), every rmsnorm and bias on
              "vec" (so too in phases 5-7: ``read_counts``); the
              first steps' logits are held against the reference backend
              (qwen in bf16 at full depth, the Mamba stacks in f32 at 12
              layers, mixtral in f32 at 16 with its bf16 numbers printed,
              see below).  Each model's weights are
              freed before the next one loads.
5. f32      — full width in f32 at reduced depth (qwen2.5-3b, mamba2-2.7b
              and mixtral-8x7b at 2 layers, zamba2-2.7b at 12 = 2 groups):
              hopper and reference token streams must be identical for
              {contiguous, paged} x {prefill chunk 1, 16} (mamba2: chunk
              1 and 16 only; mixtral: paged, its window refuses
              contiguous chunks) and, paged, for the bf16 and int8 pools
              (mixtral over the bf16 pool token by token: identical, or
              split at a shown near tie, see below); the hopper runs'
              launches are counted, all their decodes and chunks on the
              template.
6. check    — ``--check``'s helper (``serving/checks.py``) for each arch
              on the hopper backend: token-by-token decode of a 160-token
              prompt (which crosses mamba2's SSD chunk of 128 in the
              forward) against the teacher-forced forward, in f32 at the
              phase-5 depths within JAX's 2e-2 (and mamba2 at 12 layers;
              mixtral with capacity_factor lifted to its expert count, as
              the forward and decode otherwise drop different tokens), and
              qwen2.5-3b in bf16 at full depth within 5% of the logits'
              scale, with exact launch counts and the forward's and the
              decode's routes (tc and split in bf16, the template's in
              f32).
7. train    — (a) qwen2.5-3b at full width and depth in bf16: one loss
              and grads on the hopper lowering against the reference
              lowering from the same params (loss within 1%, each grad
              leaf within 5% in relative L2), the reference's own
              bf16-vs-f32 gap printed beside it; (b) 4 AdamW steps at B 2 x
              S 256 through ``launch/train.py``'s loop, each step under
              ``set_sync_debug_mode("error")`` with exact launch counts
              (remat runs each layer's forward twice) and every gemm and
              attention forward and backward on its tensor-core route
              (also in (a)) and every rmsnorm_bwd on the vector kernel,
              then one step
              under the profiler for the device's busy share and one in
              halves on the host clock; (c) qwen2.5-3b and
              mamba2-2.7b in f32 at 2 layers: loss and grads, then 2
              ``make_train_step`` steps, hopper against reference
              (``close_state`` states the tolerances).
8. caffe    — the Caffe forward (the TEST phase): LeNet-MNIST and
              LeNet-CIFAR-10 quick at the solvers' batch of 64 in f32,
              seeded params with perturbed biases, data from the port's
              image stream on the card, through ``Solver.make_eval_step``
              under ``set_sync_debug_mode("error")`` with exact launch
              counts and every gemm on the route ``kernels/gemm.py:plan``
              names for its product (``caffe_gemm_routes``), every
              maxpool on "plane", every relu on "vec" and every bias on
              "vec" but N = 10's on "scalar", every softmax_xent on
              "rows" (``caffe_fwd_routes``; in ``transfer+transpose``
              maxpool and softmax_xent on "strided"), held against
              the reference backend; MNIST's deploy
              form (a Softmax ``prob`` on ``ip2``) through ``Net.forward``
              without labels in the three boundary modes, its softmax on
              "rows" (in ``transfer+transpose`` on "strided"); under grad
              relu, conv2d, maxpool and
              softmax_xent go through their autograd Functions, softmax
              and im2col raise; each net in the paper's three boundary
              modes (equal losses, ms per forward: the forward half of
              its Table 2).
9. caffe train — Caffe's TRAIN phase, both LeNets at batch 64 in f32 on
              the hopper backend: (a) loss and grads against the
              reference lowering, ``Net.backward_manual`` against
              autograd; (b) 3 ``Solver.make_train_step`` steps under
              ``set_sync_debug_mode("error")`` with exact launch counts
              and gemm routes,
              the states held against the reference lowering's, and one
              step in each crossing mode held against the fused one; (c)
              ``Solver.solve`` on LeNet-MNIST for 300 iterations: the loss
              halves and the test accuracy passes 0.8; in (b) every
              relu_bwd takes "vec" in the fused and ``transfer`` steps and
              "strided" in ``transfer+transpose`` (a column-major x, a
              row-major dy: ``caffe_relu_bwd_routes``), every maxpool
              "plane" and every relu "vec" ("strided" and "vec" in
              ``transfer+transpose``: ``caffe_fwd_routes``), every
              softmax_xent "rows" ("strided" in ``transfer+transpose``),
              every MNIST maxpool_bwd "window" in all three modes
              (``caffe_pool_bwd_routes``) and every softmax_xent_bwd
              "rows" in all three modes (``caffe_xent_bwd_routes``); (d)
              the paper's Table 2, forward + backward (ms per iteration in
              the three boundary modes, ms per train step, one profiled
              step's device busy share: CIFAR's with no
              ``indexing_backward_kernel`` and one aten average-pool
              backward a pool, and the backward node and forward op behind
              each, with the window gather's autograd forced and
              without).
10. direct  — the direct convolution: both LeNets' forward at batch 64
              in f32 on the hopper backend, then ``ops.conv2d_direct`` on
              each Convolution layer's bottom blob under
              ``set_sync_debug_mode("error")``, one launch a layer (MNIST
              2, CIFAR 3), each on the "reg" kernel, and no other, held to
              the layer's top blob from
              the net's im2col + gemm kernels and to the plain version;
              ms per layer and per net against the im2col + gemm form.

The random 64- and 54-layer Mamba stacks are chaotic: the plain reference
alone, in bf16 and in f32 on the same weights, disagrees on nearly every
top-1 token, and f32 rounding alone grows to several per cent of the
logits at full depth (PERF.md, section 6).  So no end-to-end tolerance at
full depth can tell a kernel fault from amplified rounding: phase 4
prints the full-depth bf16 numbers and holds mamba2 and zamba2 in f32 at
full width and 12 layers, and phases 5 and 6 hold them at reduced depth.
A top-k router is discontinuous in the same way: a near tie that rounds
the other way on one side sends a token to another expert, and the plain
reference's own bf16 and f32 runs on the same weights disagree as much
as hopper and reference do.  So mixtral's bf16 logits are printed beside
that gap, its f32 logits are held within 1% at 16 layers (each layer's
weights cast to f32 only while it runs), and phase 3 holds every kernel
at its shapes.  Over a bf16 pool the same router can turn a last-bit
difference that rounds to the neighbouring bf16 value into another
token: where phase 5 finds mixtral's streams split there, it finds the
first decision the two runs take differently and requires it to be a
near tie, and each step from the same caches to agree
(``synced_steps``).  Nothing is cut in width; depth is cut only in
those checks, in phase 7's f32 comparisons (2 layers) and, for mixtral,
to fit the card.  The LeNets run at full size (Caffe's own nets) and
the solvers' batch of 64.

The line before the last is a JSON object with one entry per kernel (the
routed kernels' -- the gemm's, the attention backward's and forward's,
the three decodes', the three chunked prefills', rmsnorm_bwd's,
conv2d_direct's, relu_bwd's, maxpool's, relu's, ssd_scan's,
softmax's, rmsnorm's, bias_add_rows', im2col's, col2im's, softmax_xent's,
maxpool_bwd's and softmax_xent_bwd's -- with ``routes``:
the main paths' launches per route, phases 4-10); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
TRAIN_B, TRAIN_S = 2, 256  # the training phase's batch: 512 tokens a step
SEED = 0
T_START = time.perf_counter()


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

    # ---------------------------------------------------------------- 5
    for name, n in phase_f32(torch).items():
        launches[name] += n

    # ---------------------------------------------------------------- 6
    for name, n in phase_check(torch).items():
        launches[name] += n

    # ---------------------------------------------------------------- 7
    for name, n in phase_train(torch).items():
        launches[name] += n

    # ---------------------------------------------------------------- 8
    for name, n in phase_caffe(torch).items():
        launches[name] += n

    # ---------------------------------------------------------------- 9
    for name, n in phase_caffe_train(torch).items():
        launches[name] += n

    # --------------------------------------------------------------- 10
    for name, n in phase_direct(torch).items():
        launches[name] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in ROUTED:
            # the main paths' launches per route, and the files of the
            # routes they took
            k["routes"] = MAIN_ROUTES[k["name"]]
            k["source"] = " + ".join(sorted({
                ROUTE_SOURCES[(k["name"], r)]
                for r, n in k["routes"].items() if n}))
        if not k["launches"]:
            raise SystemExit(f"chip_smoke: {k['name']} never launched on "
                             "a serving, check, training, Caffe or direct "
                             "convolution path")

    print(f"[done] {time.perf_counter() - T_START:.1f} s", flush=True)
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

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        SPLIT_TILE,
        flash_attention,
        flash_decode,
        flash_decode_paged,
        flash_decode_paged_quant,
        flash_prefill_chunk,
        flash_prefill_chunk_paged,
        flash_prefill_chunk_paged_quant,
    )
    from repro_torch.serving import pager as PG
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.mamba_scan import ssd_scan

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def check(name, got, want, tol_rel):
        """max |got - want| <= tol_rel * max |want|, for each output of a
        kernel that returns several (y and state; out and lse)."""
        if isinstance(got, tuple):
            return max(check(f"{name}[{i}]", g, w, tol_rel)
                       for i, (g, w) in enumerate(zip(got, want)))
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
    # The int8 kernels' plain versions return f32 (the dequantized V is
    # f32), the kernels round once to q's dtype: two bf16 ulps as well.
    attn = ("flash_decode", "flash_decode_paged", "flash_prefill_chunk",
            "flash_prefill_chunk_paged", "flash_decode_paged_quant",
            "flash_prefill_chunk_paged_quant")
    TOL = {("bfloat16", "gemm"): 2 ** -7, ("bfloat16", "rmsnorm"): 2 ** -7,
           ("bfloat16", "bias_add_rows"): 0.0,
           ("float32", "gemm"): 1e-5, ("float32", "rmsnorm"): 1e-6,
           ("float32", "bias_add_rows"): 0.0}
    TOL.update({("bfloat16", n): 2 ** -6 for n in attn})
    TOL.update({("float32", n): 1e-5 for n in attn})
    # the forward attention as its siblings; the SSD scan computes in f32
    # on both sides from the same inputs and rounds y once: one bf16 ulp
    TOL.update({("bfloat16", "flash_attention"): 2 ** -6,
                ("float32", "flash_attention"): 1e-5,
                ("bfloat16", "ssd_scan"): 2 ** -7,
                ("float32", "ssd_scan"): 1e-5})
    # the backward kernels: both sides compute in f32 from the same inputs
    # and round each output once (one bf16 ulp); f32: summation order
    TOL.update({("bfloat16", "rmsnorm_bwd"): 2 ** -7,
                ("float32", "rmsnorm_bwd"): 1e-5,
                ("bfloat16", "flash_attention_bwd"): 2 ** -7,
                ("float32", "flash_attention_bwd"): 1e-5})
    # the Caffe kernels: im2col copies, maxpool compares and selects, relu
    # passes x through or multiplies once in f32 as the plain version does:
    # all exact.  The softmax pair: both sides in f32 from the same inputs,
    # another summation order over V terms (f32), rounded once (one bf16
    # ulp)
    TOL.update({(dt, n): 0.0 for dt in ("float32", "bfloat16")
                for n in ("im2col", "maxpool", "relu")})
    TOL.update({(dt, n): tol for dt, tol in (("float32", 1e-5),
                                             ("bfloat16", 2 ** -7))
                for n in ("softmax", "softmax_xent")})
    # the Caffe backward kernels: maxpool_bwd copies the winner's dy and
    # relu_bwd passes dy through or multiplies once in f32, as the plain
    # versions do: exact.  col2im sums up to K*K taps in f32 (the plain
    # scatter-add in another, atomic order); bf16 is held to the plain
    # version computed in f32 and rounded once, as the kernel rounds: one
    # bf16 ulp.  softmax_xent_bwd subtracts and scales in f32 and rounds
    # once; the plain version rounds p - onehot to p's dtype first and
    # divides by B (exact at B = 64): one bf16 ulp, f32 one rounding; both
    # then multiply by the same g and round again
    TOL.update({(dt, n): 0.0 for dt in ("float32", "bfloat16")
                for n in ("maxpool_bwd", "relu_bwd")})
    TOL.update({("float32", "col2im"): 1e-5, ("bfloat16", "col2im"): 2 ** -7,
                ("float32", "softmax_xent_bwd"): 1e-6,
                ("bfloat16", "softmax_xent_bwd"): 2 ** -7})
    # conv2d_direct: sums of up to C*KH*KW = 800 f32 products in another
    # order (f32); both sides accumulate the same bf16 products in f32 and
    # round once (one bf16 ulp)
    TOL.update({("float32", "conv2d_direct"): 1e-5,
                ("bfloat16", "conv2d_direct"): 2 ** -7})
    # the training shapes' products take 5 timed launches each (the
    # head's take 15-30 ms)
    slow = Timer(torch, reps=5, warm=1)
    cfg_d, d_ff, vocab = 2048, 11008, 151936
    rows = []          # one per (kernel, case)

    def run(kernel, case, dtype, step, count, kfn, pfn, lfn, nbytes, flops,
            tol=None, clock=timer, im2col_gemm=None, forced=None):
        """``count``: launches of this case in one bf16 ``step``
        ("decode" or "prefill") of the serving phase at B = 4, or one
        ``train`` step of phase 7 (B = 2, S = 256).  ``im2col_gemm``: the
        port's im2col + gemm form of a convolution, a second yardstick.
        ``forced``: a context that puts the kernel back on the route it
        took before a redesign (``forced_skinny``, ``forced_scalar``,
        ``forced_template``), under which ``kfn`` is timed too.  A routed
        kernel's row names the route its wrapper took."""
        name = kernel.__name__
        dt = str(dtype).split(".")[1]
        before = dict(getattr(kernel, "routes", {}))
        got = kfn()
        route = "+".join(r for r, n in getattr(kernel, "routes", {}).items()
                         if n != before[r]) or "-"
        err = check(f"{name} {case} {dtype}", got, pfn(),
                    TOL[(dt, name)] if tol is None else tol)
        del got
        ms, p_ms = clock(kfn), clock(pfn)
        l_ms = clock(lfn) if lfn is not None else None
        g_ms = clock(im2col_gemm) if im2col_gemm is not None else None
        s_ms = None
        if forced is not None:
            with forced():
                s_ms = clock(kfn)
        b_ms, by = bound_ms(nbytes, flops, dt)
        rows.append(dict(name=name, case=case, dtype=dt, step=step,
                         route=route, count=count, err=err, ms=ms,
                         plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=by,
                         im2col_gemm_ms=g_ms, forced_ms=s_ms))
        lib = f"{l_ms:.4f}" if l_ms is not None else "n/a"
        gem = f"  im2col+gemm {g_ms:.4f} ms" if g_ms is not None else ""
        sk = (f"  {forced.__name__.split('_')[1]} {s_ms:.4f} ms"
              if s_ms is not None else "")
        print(f"[3 kernels] {name:31s} {case:50s} {dt:8s} {step:7s} "
              f"{route:9s} x{count:<3d} {ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({by})  plain "
              f"{p_ms:.4f} ms  library {lib} ms{gem}{sk}  max_abs_err "
              f"{err:.3g}", flush=True)
        return route

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
        # the recurrent archs' decode steps (d 2560, d_inner 5120): extra
        # figures, not in the JSON line's qwen totals
        a25, h51 = rnd((B, 2560), dtype), rnd((B, 5120), dtype)
        h10 = rnd((B, 10240), dtype)
        w_o51 = rnd((5120, 2560), dtype, 5120 ** -0.5)
        gemms += [
            ("w_in 4x2560 @ 2560x10576", a25,
             rnd((2560, 10576), dtype, 2560 ** -0.5), "mamba2 decode", 64),
            ("w_out 4x5120 @ 5120x2560", h51, w_o51, "mamba2 decode", 64),
            ("head 4x2560 @ embed.T 50280 (NT)", a25,
             rnd((50280, 2560), dtype, 0.02).T, "mamba2 decode", 1),
            ("w_in 4x2560 @ 2560x10448", a25,
             rnd((2560, 10448), dtype, 2560 ** -0.5), "zamba2 decode", 54),
            ("w_out 4x5120 @ 5120x2560", h51, w_o51, "zamba2 decode", 54),
            ("wq,wk,wv,wo 4x2560 @ 2560x2560", a25,
             rnd((2560, 2560), dtype, 2560 ** -0.5), "zamba2 decode", 36),
            ("wg,wi 4x2560 @ 2560x10240", a25,
             rnd((2560, 10240), dtype, 2560 ** -0.5), "zamba2 decode", 18),
            ("wo 4x10240 @ 10240x2560", h10,
             rnd((10240, 2560), dtype, 10240 ** -0.5), "zamba2 decode", 9),
            ("head 4x2560 @ 2560x32000", a25,
             rnd((2560, 32000), dtype, 2560 ** -0.5), "zamba2 decode", 1),
        ]
        # mixtral-8x7b at 16 layers (d 4096, 8 kv heads of 128, untied
        # head): its attention projections and head at M = 4 and M = 64 (the
        # prefill step's head runs at M = 4); its experts run outside the
        # kernels
        a40, a40c = rnd((B, 4096), dtype), rnd((B * c, 4096), dtype)
        w_mq = rnd((4096, 4096), dtype, 4096 ** -0.5)
        w_mkv = rnd((4096, 1024), dtype, 4096 ** -0.5)
        w_mh = rnd((4096, 32000), dtype, 4096 ** -0.5)
        for x_, m_, step in ((a40, B, "mixtral decode"),
                             (a40c, B * c, "mixtral prefill")):
            gemms += [
                (f"wq,wo {m_}x4096 @ 4096x4096", x_, w_mq, step, 16 * 2),
                (f"wk,wv {m_}x4096 @ 4096x1024", x_, w_mkv, step, 16 * 2),
                (f"head {m_}x4096 @ 4096x32000", x_, w_mh, step,
                 1 if m_ == B else 0)]
        gemms.append(("head 4x4096 @ 4096x32000", a40, w_mh,
                      "mixtral prefill", 1))
        for case, x, w, step, count in gemms:
            m, k = x.shape
            n = w.shape[1]
            run(gemm, case, dtype, step, count,
                lambda x=x, w=w: gemm(x, w), lambda x=x, w=w: ref.gemm(x, w),
                lambda x=x, w=w: torch.matmul(x, w),
                (m * k + k * n + m * n) * es, 2.0 * m * n * k)
        del gemms, w_qo, w_kv, w_gi, w_o, w_mq, w_mkv, w_mh
        norm_bias_kernels(torch, F, rnd, run, timer, dtype, es)

        # -- attention: the contiguous cache and a shuffled page pool that
        # holds the same keys (every block below a row's length mapped), at
        # qwen2.5-3b's heads (16/2 of 128, 36 layers), zamba2-2.7b's
        # shared block (32/32 of 80, applied 9 times per step) and
        # mixtral-8x7b's (32/8 of 128, 16 layers, served paged only; its
        # window of 4096 spans the cache like None).  (launches per step
        # on the contiguous slab, on the pool)
        # glm4-9b's group of 16 (32/2 heads), deepseek-coder-33b's 7 (56/8)
        # and internlm2-20b's 6 (48/8), head dim 128: dense archs the
        # serving phases do not run (counts 0); a group of 32 (32/1), which
        # no arch has, takes the split decode's second block of 16 rows
        for hq, hkv, hd, arch in ((16, 2, 128, ""), (32, 32, 80, "zamba2 "),
                                  (32, 8, 128, "mixtral "),
                                  (32, 2, 128, "glm4 "),
                                  (56, 8, 128, "deepseek "),
                                  (48, 8, 128, "internlm2 "),
                                  (32, 1, 128, "g32 ")):
            n_slab, n_pool = {"": (36, 36), "zamba2 ": (9, 9),
                              "mixtral ": (0, 16)}.get(arch, (0, 0))
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
            width = torch.tensor(width_l, dtype=torch.int32, device="cuda")
            q = rnd((B, hq, hd), dtype)
            qc = rnd((B, c, hq, hd), dtype)
            kc = rnd((B, smax, hkv, hd), dtype)
            vc = rnd((B, smax, hkv, hd), dtype)
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
                count, pcount = ((n_slab, n_pool) if window is None
                                 else (0, 0))
                # decode: every live key read once.  bf16 on the split
                # kernel, timed beside the template it left; f32 stays on
                # the template
                keys = sum(n if window is None else min(n, window)
                           for n in lens_l)
                dbytes = (2 * B * hq * hd + 2 * keys * hkv * hd) * es
                dflops = 4.0 * keys * hq * hd
                bf = dtype == torch.bfloat16
                want_route("flash_decode", run(
                    flash_decode,
                    f"q 4x{hq}x{hd}, cache 4x128x{hkv}x{hd}{win}", dtype,
                    arch + "decode", count,
                    lambda w=window: flash_decode(q, kc, vc, lens, window=w),
                    lambda w=window: ref.attention_decode(q, kc, vc, lens,
                                                          window=w),
                    lambda m_=dmask: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=m_, enable_gqa=True),
                    dbytes, dflops,
                    forced=forced_template("flash_decode") if bf else None),
                    "split" if bf else "template")
                want_route("flash_decode_paged", run(
                    flash_decode_paged,
                    f"q 4x{hq}x{hd}, pool {n_pages}+1x16x{hkv}x{hd}{win}",
                    dtype, arch + "decode", pcount,
                    lambda w=window: flash_decode_paged(q, kp, vp, lens, bt,
                                                        window=w),
                    lambda w=window: ref.attention_decode_paged(
                        q, kp, vp, lens, bt, window=w),
                    lambda m_=dmask: F.scaled_dot_product_attention(
                        qs, kg, vg, attn_mask=m_, enable_gqa=True),
                    dbytes + bt_bytes, dflops,
                    forced=(forced_template("flash_decode_paged") if bf
                            else None)),
                    "split" if bf else "template")
                if bf and window is None and count:
                    decode_split_sweep(
                        timer, "flash_decode",
                        f"{arch or 'qwen2.5-3b '}heads",
                        lambda: flash_decode(q, kc, vc, lens),
                        B, hkv, -(-smax // SPLIT_TILE), SPLIT_TILE)
                if bf and window is None and pcount:
                    decode_split_sweep(
                        timer, "flash_decode_paged",
                        f"{arch or 'qwen2.5-3b '}heads",
                        lambda: flash_decode_paged(q, kp, vp, lens, bt),
                        B, hkv, maxb, page)
                if bf and window is None and not arch:
                    host_enqueue_us(
                        torch, "flash_decode", "qwen2.5-3b heads",
                        lambda: flash_decode(q, kc, vc, lens),
                        forced_template("flash_decode"),
                        lambda m_=dmask: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=m_, enable_gqa=True))
                    host_enqueue_us(
                        torch, "flash_decode_paged", "qwen2.5-3b heads",
                        lambda: flash_decode_paged(q, kp, vp, lens, bt),
                        forced_template("flash_decode_paged"),
                        lambda m_=dmask: F.scaled_dot_product_attention(
                            qs, kg, vg, attn_mask=m_, enable_gqa=True))
                # chunk: the keys the tile union needs, once; every query row
                # (padding rows alias the last real one) over its valid keys
                ckeys = sum(s0 + w0 - (0 if window is None
                                       else max(0, s0 - window + 1))
                            for s0, w0 in zip(start_l, width_l))
                nvalid = cmask.sum().item()
                cbytes = (2 * B * c * hq * hd + 2 * ckeys * hkv * hd) * es
                cflops = 4.0 * nvalid * hq * hd
                # bf16 on the tensor-core chunk kernel, timed beside the
                # template it left; f32 and the pool of q's dtype stay on
                # the template
                want_route("flash_prefill_chunk", run(
                    flash_prefill_chunk,
                    f"q 4x16x{hq}x{hd}, cache 4x128x{hkv}x{hd}{win}",
                    dtype, arch + "prefill", count,
                    lambda w=window: flash_prefill_chunk(
                        qc, kc, vc, start, width, window=w),
                    lambda w=window: ref.attention_prefill_chunk(
                        qc, kc, vc, start, width, window=w),
                    lambda m_=cmask: F.scaled_dot_product_attention(
                        qcs, ks, vs, attn_mask=m_, enable_gqa=True),
                    cbytes, cflops,
                    forced=(forced_template("flash_prefill_chunk") if bf
                            else None)),
                    "tc" if bf else "template")
                want_route("flash_prefill_chunk_paged", run(
                    flash_prefill_chunk_paged,
                    f"q 4x16x{hq}x{hd}, pool {n_pages}+1x16x{hkv}x{hd}{win}",
                    dtype, arch + "prefill", pcount,
                    lambda w=window: flash_prefill_chunk_paged(
                        qc, kp, vp, start, width, bt, window=w),
                    lambda w=window: ref.attention_prefill_chunk_paged(
                        qc, kp, vp, start, width, bt, window=w),
                    lambda m_=cmask: F.scaled_dot_product_attention(
                        qcs, kg, vg, attn_mask=m_, enable_gqa=True),
                    cbytes + bt_bytes, cflops,
                    forced=(forced_template("flash_prefill_chunk_paged")
                            if bf else None)),
                    "tc" if bf else "template")
                if bf and window is None and count:
                    chunk_sweep(
                        timer, "flash_prefill_chunk",
                        f"{arch or 'qwen2.5-3b '}heads",
                        lambda: flash_prefill_chunk(qc, kc, vc, start,
                                                    width),
                        B, hkv, hq // hkv, c, smax)
                if bf and window is None and pcount:
                    chunk_sweep(
                        timer, "flash_prefill_chunk_paged",
                        f"{arch or 'qwen2.5-3b '}heads",
                        lambda: flash_prefill_chunk_paged(qc, kp, vp, start,
                                                          width, bt),
                        B, hkv, hq // hkv, c, maxb * page)
                if bf and window is None and not arch:
                    host_enqueue_us(
                        torch, "flash_prefill_chunk", "qwen2.5-3b heads",
                        lambda: flash_prefill_chunk(qc, kc, vc, start,
                                                    width),
                        forced_template("flash_prefill_chunk"),
                        lambda m_=cmask: F.scaled_dot_product_attention(
                            qcs, ks, vs, attn_mask=m_, enable_gqa=True),
                        route="tc")
                    host_enqueue_us(
                        torch, "flash_prefill_chunk_paged",
                        "qwen2.5-3b heads",
                        lambda: flash_prefill_chunk_paged(qc, kp, vp, start,
                                                          width, bt),
                        forced_template("flash_prefill_chunk_paged"),
                        lambda m_=cmask: F.scaled_dot_product_attention(
                            qcs, kg, vg, attn_mask=m_, enable_gqa=True),
                        route="tc")
            # -- the int8 pool: the cache's keys and values written position
            # by position through the pager's quantized write (scales reset
            # at each page's slot 0, max-merged, slots requantized), read
            # with their per-(page, head) scales; the library yardstick
            # reads a dequantized, gathered copy made outside the timed call
            kq = torch.zeros((n_pages + 1, page, hkv, hd), dtype=torch.int8,
                             device="cuda")
            vq = torch.zeros_like(kq)
            ksc = torch.zeros((n_pages + 1, hkv), device="cuda")
            vsc = torch.zeros_like(ksc)
            for p_ in range(smax):
                pos_ = torch.full((B,), p_, dtype=torch.int32, device="cuda")
                PG.write_page_quant(kq, ksc, kc[:, p_], bt, pos_, lens > p_)
                PG.write_page_quant(vq, vsc, vc[:, p_], bt, pos_, lens > p_)
            kqg = ref._gather_pages(ref._dequant(kq, ksc), bt, B).to(
                dtype).transpose(1, 2)
            vqg = ref._gather_pages(ref._dequant(vq, vsc), bt, B).to(
                dtype).transpose(1, 2)
            for window in (None, 32):
                dmask = kpos[None, :] < lens[:, None]
                cmask = kpos[None, None, :] <= qpos[:, :, None]
                if window is not None:
                    dmask = dmask & (kpos[None, :] >= lens[:, None] - window)
                    cmask = cmask & (kpos[None, None, :]
                                     > qpos[:, :, None] - window)
                dmask, cmask = dmask[:, None, None, :], cmask[:, None, :, :]
                win = f" win {window}" if window else ""
                count = n_pool if window is None else 0
                # int8 keys and values once, one f32 scale per page and
                # head for each of k and v, q and out at q's width
                lo_d = [0 if window is None else max(0, n - window)
                        for n in lens_l]
                keys = sum(n - lo for n, lo in zip(lens_l, lo_d))
                pages_d = sum(-(-n // page) - lo // page
                              for n, lo in zip(lens_l, lo_d))
                qbytes = (2 * B * hq * hd * es + 2 * keys * hkv * hd
                          + 2 * pages_d * hkv * 4 + bt_bytes)
                # bf16 on the split kernel, timed beside the template it
                # left; f32 stays on the template
                want_route("flash_decode_paged_quant", run(
                    flash_decode_paged_quant,
                    f"q 4x{hq}x{hd}, int8 pool {n_pages}+1x16x{hkv}x{hd}"
                    f"{win}", dtype, arch + "decode", count,
                    lambda w=window: flash_decode_paged_quant(
                        q, kq, vq, ksc, vsc, lens, bt, window=w),
                    lambda w=window: ref.attention_decode_paged_quant(
                        q, kq, vq, ksc, vsc, lens, bt, window=w),
                    lambda m_=dmask: F.scaled_dot_product_attention(
                        qs, kqg, vqg, attn_mask=m_, enable_gqa=True),
                    qbytes, 4.0 * keys * hq * hd + 2.0 * keys * hkv * hd,
                    forced=(forced_template("flash_decode_paged_quant")
                            if dtype == torch.bfloat16 else None)),
                    "split" if dtype == torch.bfloat16 else "template")
                if dtype == torch.bfloat16 and count:
                    decode_split_sweep(
                        timer, "flash_decode_paged_quant",
                        f"{arch or 'qwen2.5-3b '}heads{win}",
                        lambda w=window: flash_decode_paged_quant(
                            q, kq, vq, ksc, vsc, lens, bt, window=w),
                        B, hkv, maxb, page)
                if dtype == torch.bfloat16 and window is None and not arch:
                    host_enqueue_us(
                        torch, "flash_decode_paged_quant", "qwen2.5-3b heads",
                        lambda: flash_decode_paged_quant(
                            q, kq, vq, ksc, vsc, lens, bt),
                        forced_template("flash_decode_paged_quant"),
                        lambda m_=dmask: F.scaled_dot_product_attention(
                            qs, kqg, vqg, attn_mask=m_, enable_gqa=True))
                lo_c = [0 if window is None else max(0, s0 - window + 1)
                        for s0 in start_l]
                ckeys = sum(s0 + w0 - lo
                            for s0, w0, lo in zip(start_l, width_l, lo_c))
                pages_c = sum(-(-(s0 + w0) // page) - lo // page
                              for s0, w0, lo in zip(start_l, width_l, lo_c))
                nvalid = cmask.sum().item()
                qcbytes = (2 * B * c * hq * hd * es + 2 * ckeys * hkv * hd
                           + 2 * pages_c * hkv * 4 + bt_bytes)
                bf = dtype == torch.bfloat16
                want_route("flash_prefill_chunk_paged_quant", run(
                    flash_prefill_chunk_paged_quant,
                    f"q 4x16x{hq}x{hd}, int8 pool {n_pages}+1x16x{hkv}x{hd}"
                    f"{win}", dtype, arch + "prefill", count,
                    lambda w=window: flash_prefill_chunk_paged_quant(
                        qc, kq, vq, ksc, vsc, start, width, bt, window=w),
                    lambda w=window: ref.attention_prefill_chunk_paged_quant(
                        qc, kq, vq, ksc, vsc, start, width, bt, window=w),
                    lambda m_=cmask: F.scaled_dot_product_attention(
                        qcs, kqg, vqg, attn_mask=m_, enable_gqa=True),
                    qcbytes,
                    4.0 * nvalid * hq * hd + 2.0 * ckeys * hkv * hd,
                    forced=(forced_template("flash_prefill_chunk_paged_quant")
                            if bf else None)),
                    "tc" if bf else "template")
                if bf and window is None and count:
                    chunk_sweep(
                        timer, "flash_prefill_chunk_paged_quant",
                        f"{arch or 'qwen2.5-3b '}heads",
                        lambda: flash_prefill_chunk_paged_quant(
                            qc, kq, vq, ksc, vsc, start, width, bt),
                        B, hkv, hq // hkv, c, maxb * page)
                if bf and window is None and not arch:
                    host_enqueue_us(
                        torch, "flash_prefill_chunk_paged_quant",
                        "qwen2.5-3b heads",
                        lambda: flash_prefill_chunk_paged_quant(
                            qc, kq, vq, ksc, vsc, start, width, bt),
                        forced_template("flash_prefill_chunk_paged_quant"),
                        lambda m_=cmask: F.scaled_dot_product_attention(
                            qcs, kqg, vqg, attn_mask=m_, enable_gqa=True),
                        route="tc")
            if dtype == torch.float32:
                # a bf16 pool under f32 queries (kv_dtype="bf16" of an f32
                # model): both sides read the pool upcast to f32
                kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
                kbg = ref._gather_pages(kb, bt, B).float().transpose(1, 2)
                vbg = ref._gather_pages(vb, bt, B).float().transpose(1, 2)
                dmask = (kpos[None, :] < lens[:, None])[:, None, None, :]
                cmask = (kpos[None, None, :]
                         <= qpos[:, :, None])[:, None, :, :]
                keys = sum(lens_l)
                want_route("flash_decode_paged", run(
                    flash_decode_paged,
                    f"q 4x{hq}x{hd}, bf16 pool {n_pages}+1x16x{hkv}x{hd}",
                    dtype, arch + "decode", 0,
                    lambda: flash_decode_paged(q, kb, vb, lens, bt),
                    lambda: ref.attention_decode_paged(q, kb, vb, lens, bt),
                    lambda m_=dmask: F.scaled_dot_product_attention(
                        qs, kbg, vbg, attn_mask=m_, enable_gqa=True),
                    2 * B * hq * hd * es + 2 * keys * hkv * hd * 2
                    + bt_bytes, 4.0 * keys * hq * hd), "template")
                ckeys = sum(s0 + w0 for s0, w0 in zip(start_l, width_l))
                want_route("flash_prefill_chunk_paged", run(
                    flash_prefill_chunk_paged,
                    f"q 4x16x{hq}x{hd}, bf16 pool {n_pages}+1x16x{hkv}x{hd}",
                    dtype, arch + "prefill", 0,
                    lambda: flash_prefill_chunk_paged(qc, kb, vb, start,
                                                      width, bt),
                    lambda: ref.attention_prefill_chunk_paged(
                        qc, kb, vb, start, width, bt),
                    lambda m_=cmask: F.scaled_dot_product_attention(
                        qcs, kbg, vbg, attn_mask=m_, enable_gqa=True),
                    2 * B * c * hq * hd * es + 2 * ckeys * hkv * hd * 2
                    + bt_bytes, 4.0 * cmask.sum().item() * hq * hd),
                    "template")
                del kb, vb, kbg, vbg
            # a row whose pages are all unmapped (a released row) returns
            # zeros (the two paged decodes on the split kernel in bf16, the
            # two paged chunks on the tensor-core chunk kernel; all four on
            # the template in f32)
            bt_u = bt.clone()
            bt_u[B - 1] = -1
            for name, fn in (
                    ("flash_decode_paged",
                     lambda t: flash_decode_paged(q, kp, vp, lens, t)),
                    ("flash_prefill_chunk_paged",
                     lambda t: flash_prefill_chunk_paged(qc, kp, vp, start,
                                                         width, t)),
                    ("flash_decode_paged_quant",
                     lambda t: flash_decode_paged_quant(q, kq, vq, ksc, vsc,
                                                        lens, t)),
                    ("flash_prefill_chunk_paged_quant",
                     lambda t: flash_prefill_chunk_paged_quant(
                         qc, kq, vq, ksc, vsc, start, width, t))):
                got, full = fn(bt_u), fn(bt)
                torch.cuda.synchronize()
                if not (torch.isfinite(got).all() and not got[B - 1].any()
                        and torch.equal(got[: B - 1], full[: B - 1])):
                    raise SystemExit(
                        f"chip_smoke: {name}: an all-unmapped row is not "
                        "zeros, or it moved the other rows")
            print(f"[3 kernels] all-unmapped row: zeros from the four paged "
                  f"kernels ({arch or 'qwen2.5-3b '}heads, {dtype}; the "
                  f"decodes on the "
                  f"{'split' if dtype == torch.bfloat16 else 'template'} "
                  "route, the chunks on the "
                  f"{'tc' if dtype == torch.bfloat16 else 'template'} "
                  "route)", flush=True)
            del kc, vc, kp, vp, kg, vg, kq, vq, kqg, vqg
        if dtype == torch.bfloat16:
            # off the served shapes, on the tensor-core chunk kernel: a
            # 24-token chunk (a second, ragged 16-row item a q head), head
            # dim 64, a group of 3, over the slab and an int8 pool of
            # random codes and scales (pages of 16, shuffled)
            c2, hq2, hkv2, d2, smax2 = 24, 6, 2, 64, 96
            s2_l, w2_l = [40, 0, 70, 17], [24, 5, 24, 13]
            s2 = torch.tensor(s2_l, dtype=torch.int32, device="cuda")
            w2 = torch.tensor(w2_l, dtype=torch.int32, device="cuda")
            q2 = rnd((B, c2, hq2, d2), dtype)
            k2, v2 = (rnd((B, smax2, hkv2, d2), dtype) for _ in range(2))
            maxb2 = smax2 // page
            ids2 = torch.randperm(B * maxb2, generator=gen,
                                  device="cuda").int()
            bt2 = torch.full((B, maxb2), -1, dtype=torch.int32,
                             device="cuda")
            for i, (s0, w0) in enumerate(zip(s2_l, w2_l)):
                nb = -(-(s0 + w0) // page)
                bt2[i, :nb] = ids2[i * maxb2: i * maxb2 + nb]
            kq2, vq2 = (torch.randint(-127, 128, (B * maxb2 + 1, page, hkv2,
                                                  d2), generator=gen,
                                      device="cuda", dtype=torch.int8)
                        for _ in range(2))
            ksc2, vsc2 = (0.01 + 0.05 * torch.rand(
                (B * maxb2 + 1, hkv2), generator=gen, device="cuda")
                for _ in range(2))
            keys2 = sum(s0 + w0 for s0, w0 in zip(s2_l, w2_l))
            pairs2 = sum(s0 + min(i, w0 - 1) + 1 for s0, w0 in zip(s2_l, w2_l)
                         for i in range(c2))
            qo_bytes = 2 * B * c2 * hq2 * d2 * es
            want_route("flash_prefill_chunk", run(
                flash_prefill_chunk,
                f"q 4x{c2}x{hq2}x{d2}, cache 4x{smax2}x{hkv2}x{d2}", dtype,
                "prefill", 0,
                lambda: flash_prefill_chunk(q2, k2, v2, s2, w2),
                lambda: ref.attention_prefill_chunk(q2, k2, v2, s2, w2),
                None, qo_bytes + 2 * keys2 * hkv2 * d2 * es,
                4.0 * pairs2 * hq2 * d2), "tc")
            want_route("flash_prefill_chunk_paged_quant", run(
                flash_prefill_chunk_paged_quant,
                f"q 4x{c2}x{hq2}x{d2}, int8 pool {B * maxb2}+1x16x{hkv2}x"
                f"{d2}", dtype, "prefill", 0,
                lambda: flash_prefill_chunk_paged_quant(
                    q2, kq2, vq2, ksc2, vsc2, s2, w2, bt2),
                lambda: ref.attention_prefill_chunk_paged_quant(
                    q2, kq2, vq2, ksc2, vsc2, s2, w2, bt2),
                None, qo_bytes + 2 * keys2 * hkv2 * d2
                + 2 * int((bt2 >= 0).sum().item()) * hkv2 * 4
                + B * maxb2 * 4,
                4.0 * pairs2 * hq2 * d2 + 2.0 * keys2 * hkv2 * d2), "tc")
            del q2, k2, v2, kq2, vq2

        # -- the SSD scan.  B and C are column slices of an in_proj output
        # (row width 2 d_inner + 2 N + H), read in place as the model
        # passes them.  (arch, N, B, S, carried state, step, count, route):
        # mamba2's decode step and C = 16 prefill step run it 64 times,
        # zamba2's 54, on "step" and "split"; the forward case is two
        # chunks of 128 on "split".  Each row is timed beside the first
        # port's kernel forced ("block").
        ssd_cases = [("mamba2", 128, B, 1, True, "decode", 64, "step"),
                     ("mamba2", 128, B, c, True, "prefill", 64, "split"),
                     ("zamba2", 64, B, 1, True, "zamba2 decode", 54, "step"),
                     ("zamba2", 64, B, c, True, "zamba2 prefill", 54,
                      "split"),
                     ("mamba2", 128, 2, 256, False, "forward", 0, "split")]
        h_ssm, p_ssm, d_in = 80, 64, 5120

        def ssd_inputs(n, bb, ss, carried, width=None):
            """x, dt, a, B and C (column slices of an in_proj output of
            ``width``, by default the model's) and the carried state."""
            zx = rnd((bb, ss, width or 2 * d_in + 2 * n + h_ssm), dtype)
            bm = zx[..., 2 * d_in: 2 * d_in + n].reshape(bb, ss, 1, n)
            cm = zx[..., 2 * d_in + n: 2 * d_in + 2 * n].reshape(bb, ss, 1,
                                                                 n)
            xs = rnd((bb, ss, h_ssm, p_ssm), dtype)
            dts = F.softplus(rnd((bb, ss, h_ssm), torch.float32))
            a_ = -torch.exp(0.5 * rnd((h_ssm,), torch.float32))
            h0 = rnd((bb, h_ssm, p_ssm, n), torch.float32) if carried \
                else None
            return xs, dts, a_, bm, cm, h0

        def ssd_cost(n, bb, ss, carried):
            chunk = min(128, ss)
            nl = sum(min(chunk, ss - t) * (min(chunk, ss - t) + 1) // 2
                     for t in range(0, ss, chunk))
            sbytes = ((2 * bb * ss * h_ssm * p_ssm + 2 * bb * ss * n) * es
                      + 4 * (bb * ss * h_ssm + h_ssm)
                      + 4 * bb * h_ssm * p_ssm * n * (2 if carried else 1))
            sflops = 2.0 * bb * h_ssm * (nl * (n + p_ssm)
                                         + 2 * ss * p_ssm * n)
            return sbytes, sflops

        for arch, n, bb, ss, carried, step, count, want in ssd_cases:
            xs, dts, a_, bm, cm, h0 = ssd_inputs(n, bb, ss, carried)
            chunk = min(128, ss)
            cases = [(f"{arch} {bb}x{ss}x{h_ssm}x{p_ssm} N {n} chunk "
                      f"{chunk}{' state' if carried else ''}", dts, count)]
            if carried:
                # dt == 0 in the whole last row (and, in a chunk, at two
                # positions)
                dz = dts.clone()
                if ss > 1:
                    dz[:, 3] = 0
                    dz[:, 9] = 0
                dz[bb - 1] = 0
                cases.append((cases[0][0] + (", dt = 0 gaps, empty row"
                                             if ss > 1 else ", empty row"),
                              dz, 0))
            sbytes, sflops = ssd_cost(n, bb, ss, carried)
            for case, d_, cnt in cases:
                want_route("ssd_scan", run(
                    ssd_scan, case, dtype, step, cnt,
                    lambda d_=d_, h0=h0: ssd_scan(xs, d_, a_, bm, cm,
                                                  chunk=128,
                                                  initial_state=h0),
                    lambda d_=d_, h0=h0: ref.ssd_scan(xs, d_, a_, bm, cm,
                                                      chunk=chunk,
                                                      initial_state=h0),
                    None, sbytes, sflops, forced=forced_block_ssd), want)
                if d_ is not dts:
                    for how, ctx in ((want, contextlib.nullcontext),
                                     ("block", forced_block_ssd)):
                        with ctx():
                            _, fin = ssd_scan(xs, d_, a_, bm, cm, chunk=128,
                                              initial_state=h0)
                        torch.cuda.synchronize()
                        if not torch.equal(fin[bb - 1], h0[bb - 1]):
                            raise SystemExit(
                                f"chip_smoke: ssd_scan {how}: a row with "
                                "no real token changed its state")
            if dtype == torch.bfloat16 and step != "forward":
                fn = (lambda: ssd_scan(xs, dts, a_, bm, cm, chunk=128,
                                       initial_state=h0))
                plain = ref.ssd_scan(xs, dts, a_, bm, cm, chunk=chunk,
                                     initial_state=h0)
                (ssd_step_sweep if ss == 1 else ssd_split_sweep)(
                    clock=timer, check=check, case=cases[0][0], fn=fn,
                    want=plain, tol=TOL[("bfloat16", "ssd_scan")], n=n,
                    shape=tuple(xs.shape), chunk=chunk)
            elif dtype == torch.bfloat16:
                ssd_split_sweep(
                    clock=timer, check=check, case=cases[0][0],
                    fn=lambda: ssd_scan(xs, dts, a_, bm, cm, chunk=128),
                    want=ref.ssd_scan(xs, dts, a_, bm, cm, chunk=chunk),
                    tol=TOL[("bfloat16", "ssd_scan")], n=n,
                    shape=tuple(xs.shape), chunk=chunk)
            del xs, h0
        print(f"[3 kernels] ssd_scan: a row with dt = 0 throughout kept its "
              f"carried state bit for bit on step, split and block "
              f"({dtype})", flush=True)
        # B and C slices whose row stride breaks the 16-byte vectors (an
        # in_proj row 2 elements wider) take the first port's kernel
        for ss in (1, c):
            xs, dts, a_, bm, cm, h0 = ssd_inputs(
                128, B, ss, True, width=2 * d_in + 2 * 128 + h_ssm + 2)
            sbytes, sflops = ssd_cost(128, B, ss, True)
            want_route("ssd_scan", run(
                ssd_scan, f"mamba2 {B}x{ss} N 128 state, B/C row stride "
                f"{bm.stride(1)} (off the vectors)", dtype, "off path", 0,
                lambda: ssd_scan(xs, dts, a_, bm, cm, chunk=128,
                                 initial_state=h0),
                lambda: ref.ssd_scan(xs, dts, a_, bm, cm, chunk=ss,
                                     initial_state=h0),
                None, sbytes, sflops), "block")
        # the serving path has the kernel write the new state over the
        # carried one: on "step" (decode) and "split" (a chunk) it equals
        # writing a new tensor; grouped B/C (no configuration has them)
        # raise in the ops layer instead of taking the plain version
        for ss, want in ((1, "step"), (c, "split")):
            xs, dts, a_, bm, cm, h0 = ssd_inputs(128, B, ss, True)
            before = dict(ssd_scan.routes)
            y0, fin = ssd_scan(xs, dts, a_, bm, cm, chunk=128,
                               initial_state=h0)
            y1, fin1 = ssd_scan(xs, dts, a_, bm, cm, chunk=128,
                                initial_state=h0, final_state=h0)
            torch.cuda.synchronize()
            took = {r for r, k in ssd_scan.routes.items() if k != before[r]}
            if took != {want} or not (fin1 is h0 and torch.equal(fin1, fin)
                                      and torch.equal(y1, y0)):
                raise SystemExit(f"chip_smoke: ssd_scan on {took}: writing "
                                 "the state in place differs from writing "
                                 "a new one")
        try:
            ops.ssd_scan(xs, dts, a_, torch.cat([bm, bm], 2),
                         torch.cat([cm, cm], 2), chunk=16)
        except ValueError:
            pass
        else:
            raise SystemExit("chip_smoke: ops.ssd_scan took grouped B/C on "
                             "the card")
        del xs, h0, fin, fin1
        print(f"[3 kernels] ssd_scan: the in-place state equals a new one "
              f"bit for bit on step and split; grouped B/C raise ({dtype})",
              flush=True)

        # -- the forward attention at the --check phase's shape, B = 2 and
        # 160 tokens: qwen2.5-3b (16/2 heads of 128) and zamba2-2.7b's
        # shared block (32/32 heads of 80), causal, and once windowed
        s_f = 160
        for hq_, hkv_, d_, window, count in ((16, 2, 128, None, 36),
                                             (32, 32, 80, None, 0),
                                             (16, 2, 128, 64, 0)):
            qf = rnd((2, s_f, hq_, d_), dtype)
            kf, vf = rnd((2, s_f, hkv_, d_), dtype), rnd((2, s_f, hkv_, d_),
                                                         dtype)
            qpos_f = torch.arange(s_f, device="cuda")
            fmask = qpos_f[None, :] <= qpos_f[:, None]
            if window is not None:
                fmask &= qpos_f[None, :] > qpos_f[:, None] - window
            pairs = int(fmask.sum().item())
            fbytes = 2 * s_f * (2 * hq_ + 2 * hkv_) * d_ * es \
                + 4 * 2 * hq_ * s_f
            qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
            win = f" win {window}" if window else ""
            # bf16 on the tensor-core kernel, timed beside the template's
            # forward mode it left; f32 stays on the template
            want_route("flash_attention", run(
                flash_attention,
                f"2x{s_f}x{hq_}x{d_}, kv {hkv_} heads, causal{win}", dtype,
                "forward", count,
                lambda w=window, q_=qf, k_=kf, v_=vf: flash_attention(
                    q_, k_, v_, window=w),
                lambda w=window, q_=qf, k_=kf, v_=vf: ref.mha_attention(
                    q_, k_, v_, window=w),
                (lambda q_=qt, k_=kt, v_=vt: F.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=True, enable_gqa=True))
                if window is None else
                (lambda q_=qt, k_=kt, v_=vt, m_=fmask:
                 F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                                enable_gqa=True)),
                fbytes, 4.0 * 2 * hq_ * d_ * pairs,
                forced=forced_scalar if dtype == torch.bfloat16 else None),
                "tc" if dtype == torch.bfloat16 else "scalar")
        train_kernels(torch, F, rnd, run, slow, dtype, es)
        gemm_crossover(torch, rnd, check, slow, dtype, TOL)
        torch.cuda.empty_cache()
    caffe_kernels(torch, F, rnd, run, timer)
    caffe_train_kernels(torch, F, rnd, run, timer)
    small_gemm_cases(torch, rnd, run, slow)
    direct_kernels(torch, F, rnd, run, timer)

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
            "src/repro_torch/kernels/csrc/flash_chunk_tc.cu",
            "src/repro/kernels/flash_attention.py:809", "prefill"),
        "flash_prefill_chunk_paged": (
            "src/repro_torch/kernels/csrc/flash_chunk_tc.cu",
            "src/repro/kernels/flash_attention.py:909", "prefill"),
        "flash_decode_paged_quant": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:654", "decode"),
        "flash_prefill_chunk_paged_quant": (
            "src/repro_torch/kernels/csrc/flash_chunk_tc.cu",
            "src/repro/kernels/flash_attention.py:1019", "prefill"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:120", "forward"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/mamba_scan.py:79", "decode"),
        "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:74", "train"),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:267", "train"),
        # the Caffe kernels: one f32 LeNet-MNIST forward at batch 64 (the
        # deploy form's for softmax)
        "im2col": ("src/repro_torch/kernels/csrc/im2col.cu",
                   "src/repro/kernels/im2col.py:57", "mnist fwd"),
        "maxpool": ("src/repro_torch/kernels/csrc/pooling.cu",
                    "src/repro/kernels/pooling.py:55", "mnist fwd"),
        "relu": ("src/repro_torch/kernels/csrc/eltwise.cu",
                 "src/repro/kernels/eltwise.py:70", "mnist fwd"),
        "softmax_xent": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                         "src/repro/kernels/softmax_xent.py:78",
                         "mnist fwd"),
        "softmax": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                    "src/repro/kernels/softmax_xent.py:35", "deploy fwd"),
        # the Caffe backward kernels: one f32 LeNet-MNIST train step at
        # batch 64
        "col2im": ("src/repro_torch/kernels/csrc/im2col.cu",
                   "src/repro/kernels/im2col.py:120", "mnist train"),
        "maxpool_bwd": ("src/repro_torch/kernels/csrc/pooling.cu",
                        "src/repro/kernels/pooling.py:123", "mnist train"),
        "relu_bwd": ("src/repro_torch/kernels/csrc/eltwise.cu",
                     "src/repro/kernels/eltwise.py:81", "mnist train"),
        "softmax_xent_bwd": ("src/repro_torch/kernels/csrc/softmax_xent.cu",
                             "src/repro/kernels/softmax_xent.py:120",
                             "mnist train"),
        # the direct convolution at LeNet-MNIST's two convolutions (phase
        # 10), batch 64
        "conv2d_direct": ("src/repro_torch/kernels/csrc/conv_direct.cu",
                          "src/repro/kernels/conv_direct.py:53",
                          "mnist direct"),
    }

    def totals(name, step):
        dt = "float32" if step in CAFFE_STEPS else "bfloat16"
        sel = [r for r in rows if r["name"] == name and r["step"] == step
               and r["dtype"] == dt and r["count"]]
        tot = {key: sum(r[key] * r["count"] for r in sel)
               for key in ("ms", "plain_ms", "bound_ms")}
        tot["library_ms"] = (
            sum(r["library_ms"] * r["count"] for r in sel)
            if all(r["library_ms"] is not None for r in sel) else None)
        tot["bytes_ms"] = sum(r["bound_ms"] * r["count"] for r in sel
                              if r["bound_by"] == "bytes")
        tot["im2col_gemm_ms"] = sum((r["im2col_gemm_ms"] or 0.0) * r["count"]
                                    for r in sel)
        # the rows timed on a forced route too: the step on the routes
        # before a redesign (the other rows' kernels unchanged)
        tot["forced_ms"] = sum(
            (r["ms"] if r["forced_ms"] is None else r["forced_ms"])
            * r["count"] for r in sel)
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
        if name == "conv2d_direct":
            out[-1]["im2col_gemm_ms"] = tot["im2col_gemm_ms"]
        lib = tot["library_ms"]
        at = {"forward": "B=2, 160 tokens",
              "train": f"B={TRAIN_B}, S={TRAIN_S}"}.get(
                  step, f"B={LENET_B}" if step in CAFFE_STEPS else f"B={B}")
        dt = "f32" if step in CAFFE_STEPS else "bf16"
        print(f"[3 kernels] {name}: one {dt} {step} step at {at}: "
              f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, library "
              f"{lib if lib is None else round(lib, 3)} ms"
              + (f", on its route before this slice "
                 f"{tot['forced_ms']:.3f} ms" if name in REDESIGNED else ""),
              flush=True)
    for step in ("mamba2 decode", "zamba2 decode", "zamba2 prefill",
                 "mixtral decode", "mixtral prefill"):
        for name in ("gemm", "rmsnorm", "flash_decode", "flash_decode_paged",
                     "flash_prefill_chunk", "flash_prefill_chunk_paged",
                     "flash_decode_paged_quant",
                     "flash_prefill_chunk_paged_quant"):
            tot = totals(name, step)
            if tot["ms"]:
                lib = tot["library_ms"]
                print(f"[3 kernels] {name}: one bf16 {step} step at B={B}:"
                      f" {tot['ms']:.3f} ms vs bound {tot['bound_ms']:.4f} "
                      f"ms, plain {tot['plain_ms']:.3f} ms, library "
                      f"{lib if lib is None else round(lib, 3)} ms"
                      + (f", on its route before this slice "
                         f"{tot['forced_ms']:.3f} ms" if name in REDESIGNED
                         else ""), flush=True)
    # the norms and biases of the steps past decode: 64 rows a prefill
    # step, 512 a train step
    for step in ("prefill", "train", "mamba2 prefill", "zamba2 prefill"):
        for name in ("rmsnorm", "bias_add_rows"):
            tot = totals(name, step)
            if tot["ms"]:
                at = (f"B={TRAIN_B}, S={TRAIN_S}" if step == "train"
                      else f"B={B}, C={c}")
                print(f"[3 kernels] {name}: one bf16 {step} step at {at}: "
                      f"{tot['ms']:.4f} ms vs bound {tot['bound_ms']:.4f} "
                      f"ms, plain {tot['plain_ms']:.4f} ms, library "
                      f"{tot['library_ms']:.4f} ms, on the scalar kernel "
                      f"forced {tot['forced_ms']:.4f} ms", flush=True)
    for step, names in (
            ("mnist fwd", ("im2col", "gemm", "bias_add_rows", "maxpool",
                           "relu", "softmax_xent")),
            ("cifar fwd", ("im2col", "gemm", "bias_add_rows", "maxpool",
                           "relu", "softmax_xent")),
            # the backward's own launches (its im2col again is the
            # forward's row)
            ("mnist train", ("gemm", "col2im", "maxpool_bwd", "relu_bwd",
                             "softmax_xent_bwd")),
            ("cifar train", ("gemm", "col2im", "relu_bwd",
                             "softmax_xent_bwd"))):
        for name in names:
            tot = totals(name, step)
            was = {"gemm": f", on the routes before the f32 small-M "
                           f"kernel {tot['forced_ms']:.4f} ms",
                   "relu_bwd": f", on the strided kernel forced "
                               f"{tot['forced_ms']:.4f} ms",
                   "maxpool": f", on the strided kernel forced "
                              f"{tot['forced_ms']:.4f} ms",
                   "relu": f", on the scalar kernel forced "
                           f"{tot['forced_ms']:.4f} ms",
                   "bias_add_rows": f", on the scalar kernel forced "
                                    f"{tot['forced_ms']:.4f} ms",
                   "im2col": f", on the flat kernel forced "
                             f"{tot['forced_ms']:.4f} ms",
                   "col2im": f", on the flat kernel forced "
                             f"{tot['forced_ms']:.4f} ms",
                   "softmax_xent": f", on the strided kernel and torch's "
                                   f"mean forced {tot['forced_ms']:.4f} ms",
                   "maxpool_bwd": f", on the pixel kernel forced "
                                  f"{tot['forced_ms']:.4f} ms",
                   "softmax_xent_bwd": f", as the first kernel and torch's "
                                       f"* g forced "
                                       f"{tot['forced_ms']:.4f} ms"}.get(
                                           name, "")
            print(f"[3 kernels] {name}: one f32 {step} at B={LENET_B}: "
                  f"{tot['ms']:.4f} ms vs bound {tot['bound_ms']:.5f} ms, "
                  f"plain {tot['plain_ms']:.4f} ms, library "
                  f"{tot['library_ms']:.4f} ms{was}", flush=True)
    tot = totals("avgpool_bwd", "cifar train")
    print(f"[3 kernels] avgpool backward: CIFAR's two 3/2 pools of one f32 "
          f"train step at B={LENET_B}: aten's gather (AvgPoolFn) "
          f"{tot['ms']:.4f} ms vs bound {tot['bound_ms']:.5f} ms, the window "
          f"gather's autograd it replaced {tot['plain_ms']:.4f} ms, aten's "
          f"call alone {tot['library_ms']:.4f} ms", flush=True)
    for step in ("mnist direct", "cifar direct"):
        tot = totals("conv2d_direct", step)
        print(f"[3 kernels] conv2d_direct: the convolutions of one f32 "
              f"{step.split()[0]} forward at B={LENET_B}: {tot['ms']:.4f} ms"
              f" vs bound {tot['bound_ms']:.5f} ms, plain "
              f"{tot['plain_ms']:.4f} ms, library (F.conv2d) "
              f"{tot['library_ms']:.4f} ms, im2col+gemm "
              f"{tot['im2col_gemm_ms']:.4f} ms, on the scalar kernel forced "
              f"{tot['forced_ms']:.4f} ms", flush=True)
    for step, what in (("prefill", f"mamba2 prefill step (C = {c})"),
                       ("zamba2 decode", "zamba2 decode step"),
                       ("zamba2 prefill", f"zamba2 prefill step (C = {c})")):
        tot = totals("ssd_scan", step)
        print(f"[3 kernels] ssd_scan: one bf16 {what} at B={B}: "
              f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, on the block kernel forced "
              f"{tot['forced_ms']:.3f} ms", flush=True)
    tot = totals("gemm", "prefill")
    print(f"[3 kernels] gemm: one bf16 prefill step at M={B * c} (the "
          f"chunk's projections; the head runs at M={B}): {tot['ms']:.3f} ms"
          f" vs bound {tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f}"
          f" ms, library {tot['library_ms']:.3f} ms", flush=True)
    tot = totals("flash_attention", "train")
    print(f"[3 kernels] flash_attention: one bf16 train step (B={TRAIN_B}, "
          f"S={TRAIN_S}: forward and rematerialized forward): "
          f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, on "
          f"its route before this slice {tot['forced_ms']:.3f} ms",
          flush=True)
    tot = totals("gemm", "train")
    print(f"[3 kernels] gemm: one bf16 train step (B={TRAIN_B}, S={TRAIN_S}:"
          f" forward, rematerialized forward and both backward products): "
          f"{tot['ms']:.3f} ms vs bound {tot['bound_ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms",
          flush=True)
    return out


CROSS_M = (1, 2, 4, 8, 16, 32, 64, 96, 128, 192, 256, 320)


def gemm_crossover(torch, rnd, check, clock, dtype, tol):
    """The skinny kernel against the tiled route (the tensor-core kernel
    in bf16, the scalar tiled one in f32) at qwen2.5-3b's projection and
    head shapes over the M of ``CROSS_M`` (decode runs at the batch, B =
    4, chunked prefill at B*C = 64, the check's teacher-forced forward at
    CHECK_B*CHECK_LEN = 320), each held against the plain version: the
    skinny kernel by raising ``gemm.SKINNY_MAX_M[dtype]`` to M, the tiled
    route by setting it to 0.  Prints each time and, for each M, the
    products of one qwen2.5-3b forward (36 layers and the head) on either
    route, whose crossover sets ``SKINNY_MAX_M[dtype]``."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ref

    dt = str(dtype).split(".")[1]
    tiled = "tc" if dtype == torch.bfloat16 else "tiled"
    d, d_ff, vocab, layers = 2048, 11008, 151936, 36
    weights = [("wq,wo", rnd((d, d), dtype, d ** -0.5), 2 * layers),
               ("wk,wv", rnd((d, 256), dtype, d ** -0.5), 2 * layers),
               ("wg,wi", rnd((d, d_ff), dtype, d ** -0.5), 2 * layers),
               ("wo", rnd((d_ff, d), dtype, d_ff ** -0.5), layers),
               ("head (NT)", rnd((vocab, d), dtype, 0.02).T, 1)]
    saved, wins = gemm_mod.SKINNY_MAX_M[dtype], []
    try:
        for m in CROSS_M:
            total = [0.0, 0.0]
            for name, w, count in weights:
                x = rnd((m, w.shape[0]), dtype)
                want = ref.gemm(x, w)
                ms = []
                for i, cut in enumerate((m, 0)):
                    gemm_mod.SKINNY_MAX_M[dtype] = cut
                    before = dict(gemm_mod.gemm.routes)
                    check(f"gemm {('skinny', tiled)[i]} {name} M={m} {dt}",
                          gemm_mod.gemm(x, w), want, tol[(dt, "gemm")])
                    route = [r for r, n in gemm_mod.gemm.routes.items()
                             if n != before[r]]
                    want_route("gemm", route[0], ("skinny",) if i == 0 else
                               (tiled, "tc_splitk"))
                    ms.append(clock(lambda x=x, w=w: gemm_mod.gemm(x, w)))
                    total[i] += count * ms[-1]
                print(f"[3 kernels] gemm crossover {dt} {name} "
                      f"{m}x{w.shape[0]} @ {w.shape[0]}x{w.shape[1]}: skinny "
                      f"{ms[0]:.4f} ms, {route[0]} {ms[1]:.4f} ms",
                      flush=True)
                del x, want
            wins.append(m if total[0] <= total[1] else None)
            print(f"[3 kernels] gemm crossover {dt} M={m}: one qwen2.5-3b "
                  f"forward's products (36 layers and the head): skinny "
                  f"{total[0]:.3f} ms, {tiled} {total[1]:.3f} ms", flush=True)
    finally:
        gemm_mod.SKINNY_MAX_M[dtype] = saved
    cuts = ", ".join(f"{str(k).split('.')[1]} {v}"
                     for k, v in gemm_mod.SKINNY_MAX_M.items())
    print(f"[3 kernels] gemm crossover {dt}: the skinny kernel is faster at "
          f"M in {[m for m in wins if m]} of {list(CROSS_M)}; SKINNY_MAX_M: "
          f"{cuts}", flush=True)
    del weights


def norm_bias_kernels(torch, F, rnd, run, clock, dtype, es):
    """Phase 3's RMSNorm forward and bias over rows at the LM paths'
    shapes: a decode step (B = 4 rows), a prefill step (B * C = 64 rows;
    its final norm runs on the B last tokens) and a train step (B 2 x S
    256 = 512 rows) of qwen2.5-3b, and mamba2's, zamba2's and mixtral's
    norms, each against its plain version, beside ``F.rms_norm`` and
    ``m + v``, on route "vec" and timed beside the first kernel forced
    (``forced_scalar_norm``, ``forced_scalar_bias``); then the edges (a
    misaligned view, a width of no whole vectors, the widest row "vec"
    takes and the next), each on the route its planner names and held to
    the plain version; and (bf16) the planners' sweeps."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.eltwise import bias_add_rows
    from repro_torch.kernels.rmsnorm import FWD_MAX_VECS, rmsnorm

    c, rows_t = CHUNK, TRAIN_B * TRAIN_S
    # (width, rows, step, launches a step): qwen2.5-3b's norms (an
    # attention and an MLP norm a layer, the final norm on the last
    # tokens), mamba2's (ln 2560 and ln_inner 5120 a layer), zamba2's (54
    # Mamba layers, 9 shared blocks), mixtral's (an attention norm and the
    # moe ln a layer)
    norms = [(2048, B, "decode", 73), (2048, B * c, "prefill", 72),
             (2048, B, "prefill", 1), (2048, rows_t, "train", 145),
             (2560, B, "mamba2 decode", 65), (5120, B, "mamba2 decode", 64),
             (2560, B * c, "mamba2 prefill", 64),
             (5120, B * c, "mamba2 prefill", 64),
             (2560, B, "mamba2 prefill", 1),
             (2560, B, "zamba2 decode", 73), (5120, B, "zamba2 decode", 54),
             (2560, B * c, "zamba2 prefill", 72),
             (5120, B * c, "zamba2 prefill", 54),
             (2560, B, "zamba2 prefill", 1),
             (4096, B, "mixtral decode", 33),
             (4096, B * c, "mixtral prefill", 32),
             (4096, B, "mixtral prefill", 1)]
    for wd, m_, step, count in norms:
        xr = rnd((m_, wd), dtype)
        wr = (1 + 0.1 * rnd((wd,), torch.float32)).to(dtype)
        want_route("rmsnorm", run(
            rmsnorm, f"{m_}x{wd}", dtype, step, count,
            lambda xr=xr, wr=wr: rmsnorm(xr, wr),
            lambda xr=xr, wr=wr: ref.rmsnorm(xr, wr),
            lambda xr=xr, wr=wr, wd=wd: F.rms_norm(xr, (wd,), wr, 1e-6),
            (2 * m_ * wd + wd) * es, 4.0 * m_ * wd,
            forced=forced_scalar_norm), "vec")
        if dtype == torch.bfloat16 and (m_, wd, step) in (
                (B, 2048, "decode"), (B, 5120, "mamba2 decode"),
                (B * c, 2048, "prefill"), (rows_t, 2048, "train")):
            norm_sweep(clock, f"{m_}x{wd}",
                       lambda xr=xr, wr=wr: rmsnorm(xr, wr), dtype, m_, wd)
    # qwen2.5-3b's q bias (2048) and k, v biases (256) a layer, at each
    # step's rows (a train step's forward and its rematerialized forward)
    for n, m_, step, count in ((2048, B, "decode", 36), (256, B, "decode", 72),
                               (2048, B * c, "prefill", 36),
                               (256, B * c, "prefill", 72),
                               (2048, rows_t, "train", 72),
                               (256, rows_t, "train", 144)):
        mm, v = rnd((m_, n), dtype), rnd((n,), dtype, 0.1)
        want_route("bias_add_rows", run(
            bias_add_rows, f"{m_}x{n} + {n}", dtype, step, count,
            lambda mm=mm, v=v: bias_add_rows(mm, v),
            lambda mm=mm, v=v: ref.bias_add_rows(mm, v),
            lambda mm=mm, v=v: mm + v,
            (2 * m_ * n + n) * es, 1.0 * m_ * n,
            forced=forced_scalar_bias), "vec")
        if dtype == torch.bfloat16:
            bias_sweep(clock, f"{m_}x{n}", lambda mm=mm, v=v: bias_add_rows(
                mm, v), dtype, m_, n)
    # the edges: (what, x, w) on the route fwd_plan names; a view offset
    # by one element, a width of no whole vectors, the widest row of whole
    # vectors "vec" takes, the next one of whole vectors
    e = 16 // es
    wide = FWD_MAX_VECS * e
    buf = rnd((B * 2048 + 1,), dtype)
    edges = [("offset by one element", buf[1:].view(B, 2048), "scalar"),
             ("width 2050", rnd((B, 2050), dtype), "scalar"),
             (f"widest vec row {wide}", rnd((B, wide), dtype), "vec"),
             (f"width {wide + e}", rnd((B, wide + e), dtype), "scalar"),
             ("row stride 2048 + 16", rnd((B, 2064), dtype)[:, :2048],
              "vec")]
    for what, x, want in edges:
        w = (1 + 0.1 * rnd((x.shape[1],), torch.float32)).to(dtype)
        got, route = routed(rmsnorm, lambda x=x, w=w: rmsnorm(x, w))
        want_route("rmsnorm", route, want)
        err = close_to(torch, f"rmsnorm {what} {dtype}", got,
                       ref.rmsnorm(x, w), 2 ** -7 if es == 2 else 1e-6)
        print(f"[3 kernels] rmsnorm edge, {what} ({tuple(x.shape)}, row "
              f"stride {x.stride(0)}) {dtype}: on {route}, max_abs_err "
              f"{err:.3g}", flush=True)
    # the bias: a view offset by one element, an N of no whole vectors, a
    # row stride past N, and the widest row of the serving path (the
    # vocabulary, 151936: the grid's blocks across columns)
    buf = rnd((B * 2048 + 1,), dtype)
    edges = [("offset by one element", buf[1:].view(B, 2048), "scalar"),
             ("N 2050", rnd((B, 2050), dtype), "scalar"),
             ("row stride 2048 + 16", rnd((B, 2064), dtype)[:, :2048],
              "vec"),
             ("N 151936", rnd((B, 151936), dtype), "vec")]
    for what, m, want in edges:
        v = rnd((m.shape[1],), dtype, 0.1)
        got, route = routed(bias_add_rows, lambda m=m, v=v: bias_add_rows(
            m, v))
        want_route("bias_add_rows", route, want)
        err = close_to(torch, f"bias_add_rows {what} {dtype}", got,
                       ref.bias_add_rows(m, v), 0.0)
        print(f"[3 kernels] bias_add_rows edge, {what} ({tuple(m.shape)}, "
              f"row stride {m.stride(0)}) {dtype}: on {route}, max_abs_err "
              f"{err:.3g}", flush=True)


def routed(kernel, fn):
    """``fn()`` (one call of the wrapper ``kernel``) and the route it
    took."""
    before = dict(kernel.routes)
    got = fn()
    return got, "+".join(r for r, n in kernel.routes.items()
                         if n != before[r]) or "-"


def close_to(torch, name, got, want, tol_rel):
    """max |got - want|, failing unless it is at most ``tol_rel`` x max
    |want| (0: equal)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (np.isfinite(err) and err <= tol_rel
            * want.float().abs().max().item()):
        raise SystemExit(f"chip_smoke: {name}: max_abs_err {err:.3g}")
    return err


def train_kernels(torch, F, rnd, run, clock, dtype, es):
    """Phase 3 at the training shapes of phase 7 (qwen2.5-3b, B = 2,
    S = 256, so 512 rows): the two backward kernels and the gemm in the
    layouts of the forward and both backward products, each against its
    plain version, beside one PyTorch call: the backward of ``F.rms_norm``
    and of ``F.scaled_dot_product_attention`` (without their forwards)
    and ``torch.matmul``.  Counts are launches per train step (``count``
    of ``train_per_step``): every layer's forward runs twice (remat)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.rmsnorm import (
        MAX_BWD_WIDTH,
        SCALAR_MAX_WIDTH,
        rmsnorm_bwd,
    )

    rows, d, d_ff, vocab, layers = TRAIN_B * TRAIN_S, 2048, 11008, 151936, 36
    # rmsnorm_bwd: the layer norms and the final norm (d 2048); the Mamba
    # inner norm (d 5120) as an extra figure.  On the vector kernel, timed
    # beside the scalar kernel forced (``forced_scalar_bwd``); dw must be the
    # same bits on every call, and a call must run two kernels (the
    # vector kernel and the dw sum)
    for wd, step, count in ((d, "train", 2 * layers + 1),
                            (5120, "mamba2 train", 0)):
        x, dy = rnd((rows, wd), dtype), rnd((rows, wd), dtype)
        w = (1 + 0.1 * rnd((wd,), torch.float32)).to(dtype)
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = F.rms_norm(xr, (wd,), wr, 1e-6)
        want_route("rmsnorm_bwd", run(
            rmsnorm_bwd, f"{rows}x{wd}", dtype, step, count,
            lambda x=x, w=w, dy=dy: rmsnorm_bwd(x, w, dy),
            lambda x=x, w=w, dy=dy: ref.rmsnorm_bwd(x, w, dy),
            lambda y=y, xr=xr, wr=wr, dy=dy: torch.autograd.grad(
                y, (xr, wr), dy, retain_graph=True),
            (3 * rows * wd + 2 * wd) * es, 10.0 * rows * wd,
            forced=forced_scalar_bwd), "vec")
        dws = [rmsnorm_bwd(x, w, dy)[1] for _ in range(5)]
        torch.cuda.synchronize()
        if not all(torch.equal(dws[0], t) for t in dws[1:]):
            raise SystemExit(f"chip_smoke: rmsnorm_bwd {rows}x{wd} {dtype}: "
                             "dw differs between calls")
        names = kernels_of_call(torch, lambda x=x, w=w, dy=dy: rmsnorm_bwd(
            x, w, dy))
        # at most two launches a call: only the vector kernel and the dw
        # sum, each at most once (the profiler may drop a few records)
        if any(not k.startswith(("rmsnorm_bwd_vec_kernel", "dw_sum_kernel"))
               or n > 1 for k, (n, _) in names.items()):
            raise SystemExit(f"chip_smoke: rmsnorm_bwd {rows}x{wd}: one call "
                             f"ran {names}, expected the vector kernel and "
                             "the dw sum")
        print(f"[3 kernels] rmsnorm_bwd {rows}x{wd} {dtype}: dw the same "
              f"bits in 5 calls; one call's kernels (launches, device us, "
              f"L2 warm) {names or 'not measured (no device activity)'}",
              flush=True)
        if dtype == torch.bfloat16:
            rmsnorm_bwd_sweep(clock, f"{rows}x{wd}",
                              lambda x=x, w=w, dy=dy: rmsnorm_bwd(x, w, dy),
                              dtype, rows, wd)
        del x, dy, xr, wr, y, dws
    # the widest rows each route takes, and the next width, which raises:
    # the vector kernel at MAX_BWD_WIDTH (one group's f32 dw row fills the
    # block's shared memory; the next width is not whole vectors, so it
    # goes to the scalar route, which raises past SCALAR_MAX_WIDTH), and
    # the scalar kernel at SCALAR_MAX_WIDTH on rows of an odd stride
    for wd, pad, want in ((MAX_BWD_WIDTH, 0, "vec"),
                          (MAX_BWD_WIDTH + 1, 0, None),
                          (SCALAR_MAX_WIDTH, 1, "scalar"),
                          (SCALAR_MAX_WIDTH + 1, 1, None)):
        xw, gw = rnd((8, wd + pad), dtype), rnd((8, wd + pad), dtype)
        x, dy = xw[:, :wd], gw[:, :wd]
        w = (1 + 0.1 * rnd((wd,), torch.float32)).to(dtype)
        before = dict(rmsnorm_bwd.routes)
        try:
            got = rmsnorm_bwd(x, w, dy)
        except ValueError:
            if want is not None:
                raise
            print(f"[3 kernels] rmsnorm_bwd at width {wd} (row stride "
                  f"{wd + pad}) raises ValueError", flush=True)
        else:
            if want is None:
                raise SystemExit(f"chip_smoke: rmsnorm_bwd took width {wd}")
            route = [r for r, n in rmsnorm_bwd.routes.items()
                     if n != before[r]]
            want_route("rmsnorm_bwd", route[0], want)
            for g, r in zip(got, ref.rmsnorm_bwd(x, w, dy)):
                err = (g.float() - r.float()).abs().max().item()
                if not err <= (2 ** -7 if dtype == torch.bfloat16 else 1e-5) \
                        * r.float().abs().max().item():
                    raise SystemExit(f"chip_smoke: rmsnorm_bwd width {wd}: "
                                     f"max_abs_err {err:.3g}")
            print(f"[3 kernels] rmsnorm_bwd at width {wd} (row stride "
                  f"{wd + pad}) on {route[0]}, held to the plain version",
                  flush=True)
        del xw, gw, x, dy, w
    # flash_attention at the training shape: a step's forward and its
    # rematerialized forward at qwen2.5-3b's heads, and as extra figures
    # zamba2-2.7b's (32/32 of 80) and mixtral-8x7b's (32/8 of 128) under a
    # window of 32; bf16 on the tensor-core kernel, timed beside the
    # template's forward mode it left
    for hq, hkv, hd, window, step, count in (
            (16, 2, 128, None, "train", 2 * layers),
            (32, 32, 80, None, "zamba2 train", 0),
            (32, 8, 128, 32, "mixtral train", 0)):
        q = rnd((TRAIN_B, TRAIN_S, hq, hd), dtype)
        k, v = (rnd((TRAIN_B, TRAIN_S, hkv, hd), dtype) for _ in range(2))
        pos = torch.arange(TRAIN_S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        pairs = int(mask.sum().item())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        win = f" win {window}" if window else ""
        # q and out at Hq heads, k and v at Hkv, lse f32
        nbytes = (2 * hq + 2 * hkv) * TRAIN_B * TRAIN_S * hd * es \
            + 4 * TRAIN_B * hq * TRAIN_S
        want_route("flash_attention", run(
            flash_attention,
            f"{TRAIN_B}x{TRAIN_S}x{hq}x{hd}, kv {hkv} heads, causal{win}",
            dtype, step, count,
            lambda q=q, k=k, v=v, w=window: flash_attention(q, k, v,
                                                            window=w),
            lambda q=q, k=k, v=v, w=window: ref.mha_attention(q, k, v,
                                                              window=w),
            (lambda q_=qt, k_=kt, v_=vt: F.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True, enable_gqa=True))
            if window is None else
            (lambda q_=qt, k_=kt, v_=vt, m_=mask:
             F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                            enable_gqa=True)),
            nbytes, 4.0 * TRAIN_B * hq * hd * pairs,
            forced=forced_scalar if dtype == torch.bfloat16 else None),
            "tc" if dtype == torch.bfloat16 else "scalar")
        del q, k, v, qt, kt, vt
    # flash_attention_bwd: qwen2.5-3b's heads (16/2 of 128, causal), and as
    # extra figures zamba2-2.7b's (32/32 of 80) and mixtral-8x7b's (32/8 of
    # 128) under a window of 32
    for hq, hkv, hd, window, step, count in (
            (16, 2, 128, None, "train", layers),
            (32, 32, 80, None, "zamba2 train", 0),
            (32, 8, 128, 32, "mixtral train", 0)):
        q = rnd((TRAIN_B, TRAIN_S, hq, hd), dtype)
        k, v = (rnd((TRAIN_B, TRAIN_S, hkv, hd), dtype) for _ in range(2))
        do = rnd((TRAIN_B, TRAIN_S, hq, hd), dtype)
        out, lse = flash_attention(q, k, v, window=window)
        pos = torch.arange(TRAIN_S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        pairs = int(mask.sum().item())
        qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_(True)
                      for t in (q, k, v))
        yt = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
              if window is None else
              F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True))
        dot = do.transpose(1, 2)
        win = f" win {window}" if window else ""
        # q, out, do and dq at Hq heads, k, v, dk and dv at Hkv, lse f32
        nbytes = (4 * hq + 4 * hkv) * TRAIN_B * TRAIN_S * hd * es \
            + 4 * TRAIN_B * hq * TRAIN_S
        route = run(
            flash_attention_bwd,
            f"{TRAIN_B}x{TRAIN_S}x{hq}x{hd}, kv {hkv} heads, causal{win}",
            dtype, step, count,
            lambda q=q, k=k, v=v, o=out, l=lse, g=do, w=window:
                flash_attention_bwd(q, k, v, o, l, g, window=w),
            lambda q=q, k=k, v=v, o=out, l=lse, g=do, w=window:
                ref.flash_attention_bwd(q, k, v, o, l, g, window=w),
            lambda yt=yt, qt=qt, kt=kt, vt=vt, g=dot: torch.autograd.grad(
                yt, (qt, kt, vt), g, retain_graph=True),
            nbytes, 10.0 * TRAIN_B * hq * hd * pairs)
        want_route("flash_attention_bwd", route,
                   "tc" if dtype == torch.bfloat16 else "scalar")
        del q, k, v, do, out, lse, qt, kt, vt, yt
    # the backward off the training shapes: S = 200 (no multiple of the
    # 64-row tile) at B = 1; non-causal with Sk > Sq at D = 64; D = 72 (no
    # multiple of 16: the scalar kernels, in bf16 too)
    for b_, sq, sk, hq, hkv, hd, causal in (
            (1, 200, 200, 16, 2, 128, True), (2, 200, 264, 8, 2, 64, False),
            (TRAIN_B, TRAIN_S, TRAIN_S, 16, 2, 72, True)):
        q, do = (rnd((b_, sq, hq, hd), dtype) for _ in range(2))
        k, v = (rnd((b_, sk, hkv, hd), dtype) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=causal)
        qpos = torch.arange(sq, device="cuda")[:, None]
        mask = (torch.arange(sk, device="cuda")[None, :] <= qpos if causal
                else torch.ones((sq, sk), dtype=torch.bool, device="cuda"))
        pairs = int(mask.sum().item())
        qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_(True)
                      for t in (q, k, v))
        yt = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True)
        nbytes = (4 * hq * sq + 4 * hkv * sk) * b_ * hd * es \
            + 4 * b_ * hq * sq
        route = run(
            flash_attention_bwd,
            f"{b_}x{sq}x{hq}x{hd}, kv {hkv} heads x {sk} keys, "
            + ("causal" if causal else "non-causal"), dtype, "shapes", 0,
            lambda q=q, k=k, v=v, o=out, l=lse, g=do, c_=causal:
                flash_attention_bwd(q, k, v, o, l, g, causal=c_),
            lambda q=q, k=k, v=v, o=out, l=lse, g=do, c_=causal:
                ref.flash_attention_bwd(q, k, v, o, l, g, causal=c_),
            lambda yt=yt, qt=qt, kt=kt, vt=vt, g=do.transpose(1, 2):
                torch.autograd.grad(yt, (qt, kt, vt), g, retain_graph=True),
            nbytes, 10.0 * b_ * hq * hd * pairs)
        want_route("flash_attention_bwd", route,
                   "tc" if dtype == torch.bfloat16 and hd % 16 == 0
                   else "scalar")
        del q, k, v, do, out, lse, qt, kt, vt, yt
    # gemm: (case, a, b, count per train step).  The forward's products run
    # twice a step (remat); the backward's da = g @ W^T reads W^T by its
    # strides (NT), db = x^T @ g reads x^T by its strides (the A operand
    # M-contiguous); the tied head reads embed.T (NT) forward, embed (NN)
    # for its da and writes its db of (d, vocab).
    w_qo = rnd((d, d), dtype, d ** -0.5)
    w_kv = rnd((d, 256), dtype, d ** -0.5)
    w_gi = rnd((d, d_ff), dtype, d ** -0.5)
    w_o = rnd((d_ff, d), dtype, d_ff ** -0.5)
    embed = rnd((vocab, d), dtype, 0.02)
    x, h = rnd((rows, d), dtype), rnd((rows, d_ff), dtype)
    g_d, g_kv, g_ff = (rnd((rows, n), dtype) for n in (d, 256, d_ff))
    g_v = rnd((rows, vocab), dtype, 1.0 / vocab)
    gemms = [
        ("wq,wo 512x2048 @ 2048x2048", x, w_qo, 4 * layers),
        ("wk,wv 512x2048 @ 2048x256", x, w_kv, 4 * layers),
        ("wg,wi 512x2048 @ 2048x11008", x, w_gi, 4 * layers),
        ("wo 512x11008 @ 11008x2048", h, w_o, 2 * layers),
        ("head 512x2048 @ embed.T (NT)", x, embed.T, 1),
        ("da wq,wo 512x2048 @ W.T (NT)", g_d, w_qo.T, 2 * layers),
        ("da wk,wv 512x256 @ W.T (NT)", g_kv, w_kv.T, 2 * layers),
        ("da wg,wi 512x11008 @ W.T (NT)", g_ff, w_gi.T, 2 * layers),
        ("da wo 512x2048 @ W.T (NT)", g_d, w_o.T, layers),
        ("da head 512x151936 @ embed", g_v, embed, 1),
        ("db wq,wo x.T 2048x512 @ 512x2048", x.T, g_d, 2 * layers),
        ("db wk,wv x.T 2048x512 @ 512x256", x.T, g_kv, 2 * layers),
        ("db wg,wi x.T 2048x512 @ 512x11008", x.T, g_ff, 2 * layers),
        ("db wo h.T 11008x512 @ 512x2048", h.T, g_d, layers),
        ("db head x.T 2048x512 @ 512x151936", x.T, g_v, 1),
    ]
    # the tensor-core kernel's four layouts at shapes ragged against its
    # 128 x 128 x 32 tile but aligned: A read along K at 520 x 2056 (40
    # output tiles: K split in 7) and x.T read along M at 2056 x 520 (136
    # tiles: K whole), each against B read along N and along K; then an A
    # whose row stride (2060) is no multiple of 8, which takes the scalar
    # tiled kernel
    xa, bn, bk = (rnd((520, 2056), dtype), rnd((2056, 1000), dtype),
                  rnd((1000, 2056), dtype).T)
    xm, bn2, bk2 = (rnd((520, 2056), dtype).T, rnd((520, 1000), dtype),
                    rnd((1000, 520), dtype).T)
    split = "tc_splitk" if dtype == torch.bfloat16 else "tiled"
    whole = "tc" if dtype == torch.bfloat16 else "tiled"
    gemms += [
        ("A(K) B(N) 520x2056 @ 2056x1000", xa, bn, 0, split),
        ("A(K) B(K) 520x2056 @ 2056x1000 (NT)", xa, bk, 0, split),
        ("A(M) B(N) x.T 2056x520 @ 520x1000", xm, bn2, 0, whole),
        ("A(M) B(K) x.T 2056x520 @ 520x1000 (NT)", xm, bk2, 0, whole),
        ("A(K) row stride 2060 520x2056 @ 2056x1000",
         rnd((520, 2060), dtype)[:, :2056], bn, 0, "tiled")]
    for row in gemms:
        case, a, b_, count = row[:4]
        m, kk = a.shape
        n = b_.shape[1]
        # f32: a summation-order difference grows as sqrt(K)
        tol = (None if dtype == torch.bfloat16 or kk <= d_ff
               else 1e-5 * math.sqrt(kk / d_ff))
        route = run(
            gemm, case, dtype, "train" if count else "layouts", count,
            lambda a=a, b_=b_: gemm(a, b_), lambda a=a, b_=b_: ref.gemm(a, b_),
            lambda a=a, b_=b_: torch.matmul(a, b_),
            (m * kk + kk * n + m * n) * es, 2.0 * m * n * kk, tol=tol,
            clock=clock)
        # every bf16 training product on the tensor cores, f32 on the
        # scalar tiled kernel
        want_route("gemm", route, row[4] if len(row) > 4 else
                   ("tc", "tc_splitk") if dtype == torch.bfloat16
                   else "tiled")
    del gemms, w_qo, w_kv, w_gi, w_o, embed, x, h, g_d, g_kv, g_ff, g_v
    del xa, bn, bk, xm, bn2, bk2


@contextlib.contextmanager
def forced_skinny():
    """The f32 small-M route turned off (``gemm.SMALL_MAX_M`` = 0), as
    ``gemm_crossover`` forces a route: the products it takes run on the
    skinny kernel again (their route before it), and every launch inside
    must take it."""
    from repro_torch.kernels import gemm as gemm_mod

    saved, before = gemm_mod.SMALL_MAX_M, dict(gemm_mod.gemm.routes)
    gemm_mod.SMALL_MAX_M = 0
    try:
        yield
    finally:
        gemm_mod.SMALL_MAX_M = saved
    taken = {r for r, n in gemm_mod.gemm.routes.items() if n != before[r]}
    if taken != {"skinny"}:
        raise SystemExit(f"chip_smoke: forced skinny gemm took {taken}")


@contextlib.contextmanager
def forced_route(module, planner, kernel, route):
    """``module``'s ``planner`` made to name ``route`` whatever the shape,
    as ``gemm_crossover`` forces a route: every launch of the wrapper
    ``kernel`` (of ``module``) inside must take it."""
    saved, fn = getattr(module, planner), getattr(module, kernel)
    before = dict(fn.routes)
    setattr(module, planner, lambda *args: route)
    try:
        yield
    finally:
        setattr(module, planner, saved)
    taken = {r for r, n in fn.routes.items() if n != before[r]}
    if taken != {route}:
        raise SystemExit(f"chip_smoke: forced {route} {kernel} took "
                         f"{taken}")


def forced_plan(planner, kernel, route):
    """``kernels/flash_attention.py``'s ``planner`` made to name
    ``route`` for the wrapper ``kernel`` (``forced_route``)."""
    from repro_torch.kernels import flash_attention as FA

    return forced_route(FA, planner, kernel, route)


def forced_scalar():
    """The attention forward on the template's forward mode, its route
    before the tensor-core kernel."""
    return forced_plan("fwd_plan", "flash_attention", "scalar")


def forced_template(kernel):
    """For ``run``'s ``forced``: the decode or chunked prefill ``kernel``
    on the template, its route before the split or tensor-core chunk
    kernel."""
    planner = "chunk_plan" if "prefill_chunk" in kernel else "decode_plan"

    def forced_template():
        return forced_plan(planner, kernel, "template")
    return forced_template


def forced_scalar_bwd():
    """The RMSNorm backward on its scalar kernel (route "scalar"), its route
    before the vector kernel: ``bwd_plan`` made to name it."""
    from repro_torch.kernels import rmsnorm as RN

    return forced_route(RN, "bwd_plan", "rmsnorm_bwd", "scalar")


def forced_scalar_norm():
    """The RMSNorm forward on the first port's kernel (route "scalar"),
    its route before the vector kernel: ``fwd_plan`` made to name it."""
    from repro_torch.kernels import rmsnorm as RN

    return forced_route(RN, "fwd_plan", "rmsnorm", "scalar")


def forced_scalar_bias():
    """The bias over rows on the first port's kernel (route "scalar"),
    its route before the vector kernel: ``bias_plan`` made to name it."""
    from repro_torch.kernels import eltwise as EW

    return forced_route(EW, "bias_plan", "bias_add_rows", "scalar")


def forced_scalar_conv():
    """The direct convolution on the first port's kernel (route
    "scalar"), its route before the register-tiled kernel: ``plan`` made
    to name it."""
    from repro_torch.kernels import conv_direct as CD

    return forced_route(CD, "plan", "conv2d_direct", "scalar")


def forced_strided():
    """The ReLU backward on the strided kernel (route "strided"), its
    route before the vector kernel: ``relu_bwd_plan`` made to name it."""
    from repro_torch.kernels import eltwise as EW

    return forced_route(EW, "relu_bwd_plan", "relu_bwd", "strided")


def forced_strided_pool():
    """The max pool on the first port's kernel (route "strided"), its
    route before the staged-band kernel: ``maxpool_plan`` made to name
    it."""
    from repro_torch.kernels import pooling as PO

    return forced_route(PO, "maxpool_plan", "maxpool", "strided")


def forced_scalar_relu():
    """The ReLU on the first port's kernel (route "scalar"), its route
    before the vector kernel: ``relu_plan`` made to name it."""
    from repro_torch.kernels import eltwise as EW

    return forced_route(EW, "relu_plan", "relu", "scalar")


def forced_block_ssd():
    """The SSD scan on the first port's kernel (route "block"), its route
    before the step and split kernels: ``ssd_plan`` made to name it."""
    from repro_torch.kernels import mamba_scan as MS

    return forced_route(MS, "ssd_plan", "ssd_scan", "block")


def forced_strided_softmax():
    """The row softmax on the first port's kernel (route "strided"), its
    route before the register-row kernel: ``softmax_plan`` made to name
    it."""
    from repro_torch.kernels import softmax_xent as SXm

    return forced_route(SXm, "softmax_plan", "softmax", "strided")


def forced_strided_xent():
    """softmax_xent on the first port's kernel and torch's mean (route
    "strided"), its route before the register-row kernel:
    ``softmax_xent_plan`` made to name it."""
    from repro_torch.kernels import softmax_xent as SXm

    return forced_route(SXm, "softmax_xent_plan", "softmax_xent", "strided")


def forced_pixel_pool_bwd():
    """The max-pool backward on the first port's kernel (route "pixel"),
    its route before the window-owner kernel: ``maxpool_bwd_plan`` made to
    name it."""
    from repro_torch.kernels import pooling as PO

    return forced_route(PO, "maxpool_bwd_plan", "maxpool_bwd", "pixel")


def forced_flat_im2col():
    """im2col on the first port's kernel (route "flat"), its route before
    the staged-band kernel: ``im2col_plan`` made to name it."""
    from repro_torch.kernels import im2col as IC

    return forced_route(IC, "im2col_plan", "im2col", "flat")


def forced_flat_col2im():
    """col2im on the first port's kernel (route "flat"), its route before
    the tile kernel: ``col2im_plan`` made to name it."""
    from repro_torch.kernels import im2col as IC

    return forced_route(IC, "col2im_plan", "col2im", "flat")


# the loss's backward as phase 3 calls it: one call with the cotangent
# folded in, or (under ``forced_twostep_xent_bwd``) the composition it
# replaced
TWO_STEP = []


def xent_bwd_of(p, y, g):
    """``softmax_xent_bwd(p, y, g)``, or, where ``forced_twostep_xent_bwd``
    holds, ``softmax_xent_bwd(p, y) * g``: the kernel without g, then
    torch's multiply, a second launch."""
    from repro_torch.kernels.softmax_xent import softmax_xent_bwd

    if TWO_STEP:
        return softmax_xent_bwd(p, y) * g
    return softmax_xent_bwd(p, y, g)


@contextlib.contextmanager
def forced_twostep_xent_bwd():
    """The loss's backward as it ran before this slice: the first port's
    kernel (route "strided", ``softmax_xent_bwd_plan`` made to name it)
    without g, then torch's ``* g`` (``xent_bwd_of``)."""
    from repro_torch.kernels import softmax_xent as SXm

    with forced_route(SXm, "softmax_xent_bwd_plan", "softmax_xent_bwd",
                      "strided"):
        TWO_STEP.append(True)
        try:
            yield
        finally:
            TWO_STEP.pop()


@contextlib.contextmanager
def forced_windows_avgpool():
    """The average pool's backward as before this slice: torch autograd of
    ``ref.avgpool``'s window gather (an ``index_put_`` with accumulation,
    on CUDA the sort-based ``indexing_backward_kernel``):
    ``ops.avgpool_plan`` made to name "windows"."""
    from repro_torch.kernels import ops

    saved = ops.avgpool_plan
    ops.avgpool_plan = lambda *args: "windows"
    try:
        yield
    finally:
        ops.avgpool_plan = saved


def short_kernel(name):
    """A device kernel's name without its namespaces, template arguments
    and argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def backward_kernel_frames(torch, fn, names=None):
    """One call of ``fn`` (a train step) under the profiler with Python
    stacks and shapes, warmed by one call before: for each device kernel
    launched inside a backward node (every one, or those whose short name
    starts with one of ``names``), per launch the node, the port's Python frames around
    the forward op that made the node (linked by the autograd sequence
    number; where the profiler links no Python frame, that op's name and
    input shapes) and the device us.  Returns {name: [(node, frames, us),
    ...]}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()

    def frames_of(e):
        """The port's Python frames among ``e``'s parents, possibly none."""
        out, up = [], e.cpu_parent
        while up is not None:
            if "repro_torch/" in up.name:
                out.append(up.name.split("repro_torch/")[-1])
            up = up.cpu_parent
        return out

    # sequence number -> the frames of the forward ops that carry it, the
    # latest first (a custom Function's forward is one op of that name)
    fwd = {}
    for e in sorted(evs, key=lambda e: -e.time_range.start):
        if e.sequence_nr >= 0 and "Backward" not in e.name \
                and not e.name.startswith("autograd::"):
            fwd.setdefault(e.sequence_nr, []).append(
                (f"{e.name} {list(e.input_shapes or [])[:2]}", frames_of(e)))
    found = {}
    for e in evs:
        for kern in getattr(e, "kernels", None) or []:
            short = short_kernel(kern.name)
            node = e
            while node is not None and not (
                    node.sequence_nr >= 0 and "Backward" in node.name):
                node = node.cpu_parent
            if node is None or (names is not None
                                and not short.startswith(tuple(names))):
                continue
            cands = fwd.get(node.sequence_nr, [])
            frames = next((f for _, f in cands if f),
                          [op for op, _ in cands[:1]] or ["(no forward op)"])
            found.setdefault(short, []).append(
                (node.name.split(": ")[-1], frames, kern.duration))
    return found


def bitwise(torch, t):
    """``t``'s bytes, to compare two results bit for bit (``torch.equal``
    on floats holds -0 equal to +0)."""
    return t.contiguous().view(torch.uint8)


def equal_forced(torch, what, fn, forced):
    """``fn()`` on its planner's route bit for bit equal to ``fn()`` on
    the old route (``forced``): the redesigned im2col, col2im and
    maxpool_bwd keep the first kernels' values (a copy; the same f32 sums
    in the same order; dy copied as bits)."""
    got = fn()
    with forced():
        old = fn()
    torch.cuda.synchronize()
    if not torch.equal(bitwise(torch, got), bitwise(torch, old)):
        raise SystemExit(f"chip_smoke: {what}: differs from the old route "
                         "forced")


def timer_floor(torch, clock, case, numel):
    """What the phase-3 timer gives a plain f32 pass over ``numel``
    elements: a write (``fill_``) and a read (``sum``), each after the
    timer's L2 flush, beside the bytes' bound: the floor against which an
    im2col (a write of its columns), a col2im (a read of them), a
    softmax_xent or a maxpool_bwd (their bytes in and out) is read."""
    buf = torch.empty(numel, device="cuda")
    w_ms, r_ms = clock(lambda: buf.fill_(1.0)), clock(lambda: buf.sum())
    print(f"[3 kernels] timer floor, {case}: {numel} f32: write (fill_) "
          f"{w_ms:.4f} ms, read (sum) {r_ms:.4f} ms, bytes' bound "
          f"{bound_ms(4.0 * numel, 0.0, 'float32')[0]:.4f} ms", flush=True)


# the band im2col's and the tile col2im's caps swept in phase 3: items a
# block, block target (kernels/im2col.py: BAND_ITEMS, BAND_BLOCKS;
# TILE_ITEMS, TILE_BLOCKS); the larger targets split even the small
# planes' rows across blocks
BAND_SWEPT = ((32, 64, 128, 256, 512), (132, 528, 2112, 8448))
TILE_SWEPT = ((64, 128, 256, 512, 1024), (132, 528, 2112, 8448))


def im2col_sweep(clock, kernel, case, fn, plan):
    """``fn`` (an ``im2col`` call on "band", ``kernel`` "im2col", or a
    ``col2im`` call on "tile", "col2im") at each distinct block that
    ``plan()`` gives over ``BAND_SWEPT`` or ``TILE_SWEPT``, each held bit
    for bit to the planner's own output; fastest first, the planner's
    pick marked, with its rank."""
    import itertools

    import torch

    from repro_torch.kernels import im2col as IC

    names, swept = {"im2col": (("BAND_ITEMS", "BAND_BLOCKS"), BAND_SWEPT),
                    "col2im": (("TILE_ITEMS", "TILE_BLOCKS"),
                               TILE_SWEPT)}[kernel]
    saved = tuple(getattr(IC, k) for k in names)
    mine, want, cells = plan(), bitwise(torch, fn()), {}
    try:
        for values in itertools.product(*swept):
            for k, v in zip(names, values):
                setattr(IC, k, v)
            b = plan()
            if b in cells:
                continue
            if not torch.equal(bitwise(torch, fn()), want):
                raise SystemExit(f"chip_smoke: {kernel} {case} at {b}: "
                                 "differs from the planner's block")
            cells[b] = clock(fn)
    finally:
        for k, v in zip(names, saved):
            setattr(IC, k, v)
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [b for b, _ in ranked].index(mine) + 1
    print(f"[3 kernels] {kernel} {'band' if kernel == 'im2col' else 'tile'}"
          f" sweep, {case}: (rows, threads), ms (planner rank "
          f"{rank} of {len(ranked)}, {ranked[rank - 1][1] / ranked[0][1]:.3f}"
          f"x the fastest): " + "; ".join(
              f"{tuple(b)[:2]}{'*' if b == mine else ''} {t:.4f}"
              for b, t in ranked), flush=True)


def kernels_of_call(torch, fn, calls=10):
    """The device kernels one call of ``fn`` runs, name (up to its
    argument list) -> (launches a call, device us a call), from the
    profiler's CUDA activity over ``calls`` calls, L2 warm (empty if it
    records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void "):
            (e.count / calls, round(e.self_device_time_total / calls, 2))
            for e in prof.key_averages() if e.self_device_time_total > 0}


# the vector RMSNorm backward's warps a row cap, warps a block and block
# targets swept in phase 3
BWD_SWEPT = ((1, 2, 4, 8), (2, 4, 8), (128, 256, 512))


def rmsnorm_bwd_sweep(clock, case, fn, dtype, rows, d):
    """The RMSNorm backward ``fn`` on the vector kernel at each distinct
    plan (group, warps, rows a block, blocks) that ``bwd_rows`` gives for
    each ``BWD_GROUP``, ``BWD_WARPS`` and ``BWD_BLOCKS`` of ``BWD_SWEPT``,
    fastest first, on one line; the planner's own plan is marked."""
    from repro_torch.kernels import rmsnorm as RN

    saved = (RN.BWD_GROUP, RN.BWD_WARPS, RN.BWD_BLOCKS)
    mine, cells = RN.bwd_rows(dtype, rows, d), {}
    try:
        for RN.BWD_GROUP in BWD_SWEPT[0]:
            for RN.BWD_WARPS in BWD_SWEPT[1]:
                for RN.BWD_BLOCKS in BWD_SWEPT[2]:
                    plan = RN.bwd_rows(dtype, rows, d)
                    if plan not in cells:
                        cells[plan] = clock(fn)
    finally:
        RN.BWD_GROUP, RN.BWD_WARPS, RN.BWD_BLOCKS = saved
    print(f"[3 kernels] rmsnorm_bwd sweep, {case} {dtype}: group x warps x "
          f"rows a block x blocks, ms: " + "; ".join(
              f"{p}{'*' if p == mine else ''} {t:.4f}"
              for p, t in sorted(cells.items(), key=lambda c: c[1])),
          flush=True)


# the forward RMSNorm's warps a row cap, warps a block and warp targets,
# and the vec bias's rows a thread, threads a block and block targets,
# swept in phase 3
NORM_SWEPT = ((1, 2, 4, 8), (2, 4, 8), (128, 512, 1024, 2048, 4096, 8192))
BIAS_SWEPT = ((1, 2, 4, 8), (32, 64, 128, 256), (66, 132, 264, 528))


def norm_sweep(clock, case, fn, dtype, rows, d):
    """The RMSNorm forward ``fn`` on the vector kernel at each distinct
    plan (group, warps, blocks) that ``fwd_rows`` gives for each
    ``FWD_GROUP``, ``FWD_WARPS`` and ``FWD_TARGET`` of ``NORM_SWEPT``,
    fastest first, on one line; the planner's own plan is marked."""
    from repro_torch.kernels import rmsnorm as RN

    saved = (RN.FWD_GROUP, RN.FWD_WARPS, RN.FWD_TARGET)
    mine, cells = RN.fwd_rows(dtype, rows, d), {}
    try:
        for RN.FWD_GROUP in NORM_SWEPT[0]:
            for RN.FWD_WARPS in NORM_SWEPT[1]:
                for RN.FWD_TARGET in NORM_SWEPT[2]:
                    plan = RN.fwd_rows(dtype, rows, d)
                    if plan not in cells:
                        cells[plan] = clock(fn)
    finally:
        RN.FWD_GROUP, RN.FWD_WARPS, RN.FWD_TARGET = saved
    print(f"[3 kernels] rmsnorm sweep, {case} {dtype}: group x warps x "
          f"blocks, ms: " + "; ".join(
              f"{p}{'*' if p == mine else ''} {t:.4f}"
              for p, t in sorted(cells.items(), key=lambda c: c[1])),
          flush=True)


def bias_sweep(clock, case, fn, dtype, m, n):
    """The bias ``fn`` on the vector kernel at each distinct grid (rows a
    thread, bx, by, gx, gy) that ``bias_grid`` gives for each
    ``BIAS_ROWS``, ``BIAS_THREADS`` and ``BIAS_BLOCKS`` of ``BIAS_SWEPT``,
    fastest first, on one line; the planner's own grid is marked."""
    from repro_torch.kernels import eltwise as EW

    saved = (EW.BIAS_ROWS, EW.BIAS_THREADS, EW.BIAS_BLOCKS)
    mine, cells = EW.bias_grid(dtype, m, n), {}
    try:
        for EW.BIAS_ROWS in BIAS_SWEPT[0]:
            for EW.BIAS_THREADS in BIAS_SWEPT[1]:
                for EW.BIAS_BLOCKS in BIAS_SWEPT[2]:
                    grid = EW.bias_grid(dtype, m, n)
                    if grid not in cells:
                        cells[grid] = clock(fn)
    finally:
        EW.BIAS_ROWS, EW.BIAS_THREADS, EW.BIAS_BLOCKS = saved
    print(f"[3 kernels] bias sweep, {case} {dtype}: rows a thread x bx x by"
          f" x gx x gy, ms: " + "; ".join(
              f"{g}{'*' if g == mine else ''} {t:.4f}"
              for g, t in sorted(cells.items(), key=lambda c: c[1])),
          flush=True)


# the reg convolution's caps swept in phase 3: strips a block, filter
# groups a block, channel groups, channels a group a stage, block target
CONV_SWEPT = ((16, 32, 64, 128), (1, 2, 4), (1, 2, 4, 8), (1, 2, 4),
              (132, 264))


def conv_tile_sweep(clock, case, fn, x, w, stride, pad, top=6):
    """The direct convolution ``fn`` on the reg kernel at each distinct
    ``Tiles`` that ``tiles`` gives over ``CONV_SWEPT`` (``REG_MAX_STRIPS``,
    ``REG_MAX_FG``, ``REG_MAX_GROUPS``, ``REG_CHUNK``, ``REG_BLOCKS``),
    each held to the planner's own output; the fastest ``top`` and the
    planner's pick with its rank, on one line."""
    import itertools

    from repro_torch.kernels import conv_direct as CD

    names = ("REG_MAX_STRIPS", "REG_MAX_FG", "REG_MAX_GROUPS", "REG_CHUNK",
             "REG_BLOCKS")
    saved = [getattr(CD, k) for k in names]
    mine = CD.tiles(x.dtype, x.shape, w.shape, stride, pad)
    want, cells = fn(), {}
    scale = want.float().abs().max().item()
    try:
        for combo in itertools.product(*CONV_SWEPT):
            for k, v in zip(names, combo):
                setattr(CD, k, v)
            t = CD.tiles(x.dtype, x.shape, w.shape, stride, pad)
            if t in cells:
                continue
            err = (fn().float() - want.float()).abs().max().item()
            if not err <= 1e-5 * scale:
                raise SystemExit(f"chip_smoke: conv2d_direct {case} at "
                                 f"{tuple(t)}: max_abs_err {err:.3g}")
            cells[t] = clock(fn)
    finally:
        for k, v in zip(names, saved):
            setattr(CD, k, v)
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [t for t, _ in ranked].index(mine) + 1
    print(f"[3 kernels] conv2d_direct conv sweep, {case}: (filters, rows, "
          f"cols, chunk, groups, threads), ms: planner {tuple(mine)} "
          f"{cells[mine]:.4f} (rank {rank} of {len(ranked)}); fastest "
          + "; ".join(f"{tuple(t)} {ms:.4f}" for t, ms in ranked[:top]),
          flush=True)


# the vec ReLU kernels' block caps swept in phase 3 (their vectors a
# thread are fixed at compile time: csrc/eltwise.cu:kVecs)
RELU_SWEPT = (33, 66, 132, 264, 528, 1056)


def vec_grid_sweep(clock, kernel, case, fn, dtype, n):
    """The ReLU (``kernel`` "relu") or its backward ("relu_bwd") ``fn`` on
    its vec kernel at each distinct block count that ``relu_vec_grid``
    gives for ``n`` elements over ``RELU_SWEPT`` (``RELU_BLOCKS``),
    fastest first, the planner's pick marked, with
    its rank."""
    from repro_torch.kernels import eltwise as EW

    saved = EW.RELU_BLOCKS
    mine, cells = EW.relu_vec_grid(dtype, n), {}
    try:
        for EW.RELU_BLOCKS in RELU_SWEPT:
            grid = EW.relu_vec_grid(dtype, n)
            if grid not in cells:
                cells[grid] = clock(fn)
    finally:
        EW.RELU_BLOCKS = saved
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [g for g, _ in ranked].index(mine) + 1
    print(f"[3 kernels] {kernel} sweep, {case} {dtype}: blocks, ms "
          f"(planner rank {rank} of {len(ranked)}): "
          + "; ".join(f"{g}{'*' if g == mine else ''} {t:.4f}"
                      for g, t in ranked), flush=True)


# the plane max pool's caps swept in phase 3: outputs a block, block
# target, waves before planes are packed (kernels/pooling.py:
# POOL_OUTPUTS, POOL_BLOCKS, POOL_WAVES; 64 waves: never packed)
POOL_SWEPT = ((64, 128, 256, 512, 1024), (132, 264, 528, 1056), (1, 64))


def pool_band_sweep(clock, case, fn, x, k, stride, pad):
    """The max pool ``fn`` on the plane kernel at each distinct ``Band``
    that ``maxpool_band`` gives over ``POOL_SWEPT``, each held bit for bit
    (values and argmax) to the planner's own output; fastest first, the
    planner's pick marked, with its rank."""
    import itertools

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import pooling as PO

    aligned = _build.aligned16(x, elems=16 // x.element_size())

    def band():
        return PO.maxpool_band(x.dtype, x.shape, k, stride, pad, aligned)

    saved = (PO.POOL_OUTPUTS, PO.POOL_BLOCKS, PO.POOL_WAVES)
    mine, want, cells = band(), fn(), {}
    try:
        for PO.POOL_OUTPUTS, PO.POOL_BLOCKS, PO.POOL_WAVES in \
                itertools.product(*POOL_SWEPT):
            b = band()
            if b in cells:
                continue
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise SystemExit(f"chip_smoke: maxpool {case} at {b}: "
                                 "differs from the planner's band")
            cells[b] = clock(fn)
    finally:
        PO.POOL_OUTPUTS, PO.POOL_BLOCKS, PO.POOL_WAVES = saved
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [b for b, _ in ranked].index(mine) + 1
    print(f"[3 kernels] maxpool pool sweep, {case}: (rows, planes, threads)"
          f", ms (planner rank {rank} of {len(ranked)}): " + "; ".join(
              f"{tuple(b)[:3]}{'*' if b == mine else ''} {t:.4f}"
              for b, t in ranked), flush=True)


# the SSD scan's knobs swept in phase 3 (kernels/mamba_scan.py), each over
# every (lanes, vectors) pair of the state width: the step kernel's rows a
# lane group holds and warps a block (STEP_ROWS, STEP_WARPS); the split
# kernel's rows-per-chunk floor and waves (SPLIT_ROWS, SPLIT_WAVES)
STEP_SWEPT = ((1, 2, 4), (1, 2, 4, 8, 16))
SPLIT_SWEPT = ((0.125, 0.25, 0.5, 1.0, 2.0), (1, 4))


def ssd_sweep(route, clock, check, case, fn, want, tol, n, shape, chunk):
    """``fn`` (an ``ssd_scan`` call on ``route``, "step" or "split") at
    each distinct grid its planner gives over ``STEP_SWEPT`` or
    ``SPLIT_SWEPT`` and every lane pair of N: y within ``tol`` of the
    plain ``want``, the state the planner's own bit for bit (neither
    kernel's update sums across lanes or rows); fastest first, the
    planner's pick marked, with its rank."""
    import itertools

    import torch

    from repro_torch.kernels import mamba_scan as MS

    lanes_of = MS.STEP_LANES if route == "step" else MS.SPLIT_LANES
    names = (("STEP_ROWS", "STEP_WARPS") if route == "step"
             else ("SPLIT_ROWS", "SPLIT_WAVES"))

    def grid():
        return (MS.ssd_step(shape, n) if route == "step"
                else MS.ssd_split(shape, n, chunk))

    saved = (lanes_of[n],) + tuple(getattr(MS, k) for k in names)
    mine, base, cells = grid(), fn(), {}
    try:
        for lanes in [lv for lv in MS.LANES if 4 * lv[0] * lv[1] == n]:
            for knobs in itertools.product(
                    *(STEP_SWEPT if route == "step" else SPLIT_SWEPT)):
                lanes_of[n] = lanes
                for k, v in zip(names, knobs):
                    setattr(MS, k, v)
                g = grid()
                if g in cells:
                    continue
                got = fn()
                check(f"ssd_scan {case} at {g}", got[0], want[0], tol)
                if not torch.equal(got[1], base[1]):
                    raise SystemExit(f"chip_smoke: ssd_scan {case} at {g}: "
                                     "the state differs from the planner's")
                cells[g] = clock(fn)
    finally:
        lanes_of[n] = saved[0]
        for k, v in zip(names, saved[1:]):
            setattr(MS, k, v)
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [g for g, _ in ranked].index(mine) + 1
    fields = ("lanes", "vecs", "rows", "warps" if route == "step"
              else "slices")
    print(f"[3 kernels] ssd_scan {route} sweep, {case}: ({', '.join(fields)}"
          f"), ms (planner rank {rank} of {len(ranked)}): " + "; ".join(
              f"{tuple(getattr(g, f) for f in fields)}"
              f"{'*' if g == mine else ''} {t:.4f}" for g, t in ranked),
          flush=True)


def ssd_step_sweep(**kw):
    ssd_sweep("step", **kw)


def ssd_split_sweep(**kw):
    ssd_sweep("split", **kw)


# the register-row softmax's knobs swept in phase 3 (kernels/
# softmax_xent.py): items a lane aims at, threads a block aims at
SOFTMAX_SWEPT = ((1, 2, 4, 8), (32, 64, 128, 256, 512))


def softmax_rows_sweep(clock, case, x, tol):
    """``softmax(x)`` on the rows kernel at each distinct ``Rows`` that
    ``softmax_rows`` gives over ``SOFTMAX_SWEPT``, each within ``tol`` of
    the plain version; fastest first, the planner's pick marked, with its
    rank."""
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax_xent as SXm

    aligned = x.data_ptr() % 16 == 0

    def grid():
        return SXm.softmax_rows(x.dtype, x.shape, x.stride(), aligned)

    want = ref.softmax(x).float()
    saved = (SXm.SOFTMAX_ITEMS, SXm.SOFTMAX_THREADS)
    mine, cells = grid(), {}
    try:
        for SXm.SOFTMAX_ITEMS, SXm.SOFTMAX_THREADS in \
                itertools.product(*SOFTMAX_SWEPT):
            g = grid()
            if g in cells:
                continue
            err = (SXm.softmax(x).float() - want).abs().max().item()
            if not err <= tol * want.abs().max().item():
                raise SystemExit(f"chip_smoke: softmax {case} at {g}: "
                                 f"max_abs_err {err:.3g}")
            cells[g] = clock(lambda: SXm.softmax(x))
    finally:
        SXm.SOFTMAX_ITEMS, SXm.SOFTMAX_THREADS = saved
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [g for g, _ in ranked].index(mine) + 1
    print(f"[3 kernels] softmax rows sweep, {case}: (threads a row, rows a "
          f"block, items a lane), ms (planner rank {rank} of "
          f"{len(ranked)}): " + "; ".join(
              f"{tuple(g)[:3]}{'*' if g == mine else ''} {t:.4f}"
              for g, t in ranked), flush=True)


# the fused softmax + cross-entropy's knobs swept in phase 3 (kernels/
# softmax_xent.py): softmax's grid knobs it starts from (items a lane
# aims at, threads a block aims at) and the most items a lane may take to
# fit the batch in one block
XENT_SWEPT = ((1, 2, 4, 8), (64, 128, 256, 512), (1, 2, 4, 8))


def xent_rows_sweep(clock, case, x, y, tol):
    """``softmax_xent(x, y)`` on the rows kernel at each distinct ``Rows``
    that ``softmax_xent_rows`` gives over ``XENT_SWEPT``, probs and loss
    each within ``tol`` of the plain version; fastest first, the
    planner's pick marked, with its rank."""
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax_xent as SXm

    aligned = x.data_ptr() % 16 == 0

    def grid():
        return SXm.softmax_xent_rows(x.dtype, x.shape, x.stride(), aligned)

    w_loss, w_probs = ref.softmax_xent(x, y)
    w_probs = w_probs.float()
    names = ("SOFTMAX_ITEMS", "SOFTMAX_THREADS", "XENT_PACK")
    saved = tuple(getattr(SXm, k) for k in names)
    mine, cells = grid(), {}
    try:
        for values in itertools.product(*XENT_SWEPT):
            for k, v in zip(names, values):
                setattr(SXm, k, v)
            g = grid()
            if g in cells:
                continue
            loss, probs = SXm.softmax_xent(x, y)
            err = (probs.float() - w_probs).abs().max().item()
            l_err = abs(loss.item() - w_loss.item())
            if not (err <= tol * w_probs.abs().max().item()
                    and l_err <= tol * abs(w_loss.item())):
                raise SystemExit(f"chip_smoke: softmax_xent {case} at {g}: "
                                 f"max_abs_err {err:.3g}, loss {l_err:.3g}")
            cells[g] = clock(lambda: SXm.softmax_xent(x, y))
    finally:
        for k, v in zip(names, saved):
            setattr(SXm, k, v)
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [g for g, _ in ranked].index(mine) + 1
    print(f"[3 kernels] softmax_xent rows sweep, {case}: (threads a row, rows"
          f" a block, items a lane, blocks), ms (planner rank {rank} of "
          f"{len(ranked)}): " + "; ".join(
              f"{(g.tpr, g.rows, g.per, g.blocks)}"
              f"{'*' if g == mine else ''} {t:.4f}" for g, t in ranked),
          flush=True)


# the window-owner pool backward's caps swept in phase 3 (kernels/
# pooling.py): units a block aims at, blocks the grid aims at
POOL_BWD_SWEPT = ((32, 64, 128, 256, 512), (132, 264, 528, 1056))


def pool_bwd_sweep(clock, case, fn, dtype, shape, stride, pad):
    """The max-pool backward ``fn`` on the window kernel at each distinct
    ``BwdBand`` that ``maxpool_bwd_band`` gives over ``POOL_BWD_SWEPT``,
    each bit for bit the planner's own output; fastest first, the
    planner's pick marked, with its rank."""
    import itertools

    import torch

    from repro_torch.kernels import pooling as PO

    def band():
        return PO.maxpool_bwd_band(dtype, shape, stride, pad)

    saved = (PO.BWD_UNITS, PO.BWD_BLOCKS)
    mine, want, cells = band(), bitwise(torch, fn()), {}
    try:
        for PO.BWD_UNITS, PO.BWD_BLOCKS in itertools.product(
                *POOL_BWD_SWEPT):
            b = band()
            if b in cells:
                continue
            if not torch.equal(bitwise(torch, fn()), want):
                raise SystemExit(f"chip_smoke: maxpool_bwd {case} at {b}: "
                                 "differs from the planner's block")
            cells[b] = clock(fn)
    finally:
        PO.BWD_UNITS, PO.BWD_BLOCKS = saved
    ranked = sorted(cells.items(), key=lambda c: c[1])
    rank = [b for b, _ in ranked].index(mine) + 1
    print(f"[3 kernels] maxpool_bwd window sweep, {case}: (cols, groups, "
          f"planes, blocks), ms (planner rank {rank} of {len(ranked)}): "
          + "; ".join(f"{(b.cols, b.groups, b.planes, b.blocks)}"
                      f"{'*' if b == mine else ''} {t:.4f}"
                      for b, t in ranked), flush=True)


# the split decode's block targets swept in phase 3
SPLIT_TARGETS = (8, 16, 32, 64, 128, 256, 512)


def decode_split_sweep(clock, name, case, fn, b, hkv, max_blocks, page):
    """The decode ``name`` on the split kernel at each of
    ``SPLIT_TARGETS`` in place of ``DECODE_BLOCKS`` (the splits
    ``decode_splits`` then picks of ``max_blocks`` pages: block-table
    entries, or the slab's 32-key tiles), one line a case; the planner's
    own target is marked."""
    from repro_torch.kernels import flash_attention as FA

    saved, cells = FA.DECODE_BLOCKS, []
    try:
        for target in SPLIT_TARGETS:
            FA.DECODE_BLOCKS = target
            n, pps = FA.decode_splits(b, hkv, max_blocks, page)
            cells.append(f"{target}{'*' if target == saved else ''}: "
                         f"{n} x {pps} {clock(fn):.4f}")
    finally:
        FA.DECODE_BLOCKS = saved
    print(f"[3 kernels] {name} split sweep, {case}: "
          f"target blocks: splits x pages a split, ms: " + "; ".join(cells),
          flush=True)


# the tensor-core chunk kernel's warps a block swept in phase 3
CHUNK_WARPS_SWEPT = (1, 2, 4, 8)


def chunk_sweep(clock, name, case, fn, b, hkv, g, c, n_keys):
    """The chunk ``name`` on the tensor-core kernel at each of
    ``CHUNK_WARPS_SWEPT`` warps a block (``chunk_rows``' cap; 1 is a
    block a q head, K/V from L2) and each of ``SPLIT_TARGETS`` in place
    of ``CHUNK_BLOCKS`` (the splits ``chunk_splits`` then picks), one line
    a case; the planner's own pair is marked."""
    from repro_torch.kernels import flash_attention as FA

    saved, cells = (FA.CHUNK_WARPS, FA.CHUNK_BLOCKS), []
    try:
        for warps in CHUNK_WARPS_SWEPT:
            for target in SPLIT_TARGETS:
                FA.CHUNK_WARPS, FA.CHUNK_BLOCKS = warps, target
                w, n_rb = FA.chunk_rows(g, c)
                n, tps = FA.chunk_splits(b, hkv, n_rb, n_keys)
                mark = "*" if (warps, target) == saved else ""
                cells.append(f"{warps}w {target}{mark}: {w}w x {n_rb} x "
                             f"{n} x {tps} {clock(fn):.4f}")
    finally:
        FA.CHUNK_WARPS, FA.CHUNK_BLOCKS = saved
    print(f"[3 kernels] {name} chunk sweep, {case}: warps a block cap, "
          f"target blocks: warps x row blocks x splits x tiles a split, "
          f"ms: " + "; ".join(cells), flush=True)


def host_enqueue_us(torch, name, case, fn, forced, lib, route="split",
                    calls=100, trials=21):
    """Host microseconds to enqueue one call of the decode or chunk
    ``name``: on its ``route``, on the template (``forced``) and SDPA
    (``lib``), ``calls`` calls back to back on the host clock with the
    card drained before each batch, the three interleaved ``trials``
    times; the median and the least of each are printed.  The serving
    paths are host-bound, so this is what a route costs them a call."""
    ways = ((route, fn, contextlib.nullcontext), ("template", fn, forced),
            ("SDPA", lib, contextlib.nullcontext))
    times = {way: [] for way, _, _ in ways}
    for _ in range(trials):
        for way, f, ctx in ways:
            with ctx():
                f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    f()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
            times[way].append(1e6 * (t1 - t0) / calls)
    print(f"[3 kernels] {name} host enqueue, {case}, us a call (median, "
          f"least of {trials} x {calls}): " + "; ".join(
              f"{way} {statistics.median(t):.2f}, {min(t):.2f}"
              for way, t in times.items()), flush=True)


def want_route(name, route, want):
    """Fail unless ``route`` is ``want`` (or one of them)."""
    if route not in ((want,) if isinstance(want, str) else want):
        raise SystemExit(f"chip_smoke: {name} took the {route} route, "
                         f"expected {want}")


# the kernels whose routes were redesigned: each phase-3 row of theirs is
# also timed on the route it left (``forced_scalar``, ``forced_template``,
# ``forced_scalar_bwd``, ``forced_scalar_conv``, ``forced_strided``,
# ``forced_strided_pool``, ``forced_scalar_relu``, ``forced_block_ssd``,
# ``forced_strided_softmax``, ``forced_scalar_norm``,
# ``forced_scalar_bias``, ``forced_flat_im2col``, ``forced_flat_col2im``,
# ``forced_strided_xent``, ``forced_pixel_pool_bwd``,
# ``forced_twostep_xent_bwd``)
REDESIGNED = ("flash_attention", "flash_decode", "flash_decode_paged",
              "flash_decode_paged_quant", "flash_prefill_chunk",
              "flash_prefill_chunk_paged", "flash_prefill_chunk_paged_quant",
              "rmsnorm_bwd", "conv2d_direct", "relu_bwd", "maxpool", "relu",
              "ssd_scan", "softmax", "rmsnorm", "bias_add_rows", "im2col",
              "col2im", "softmax_xent", "maxpool_bwd", "softmax_xent_bwd")
# the f32 small-M kernel's routes (csrc/gemm_f32.cu), K whole or split
SMALL_ROUTES = ("f32_small", "f32_splitk")
# the Caffe forward's batch (both solvers' batch_size) and phase 3's steps
# at it: one f32 TEST-phase forward of each net and of MNIST's deploy form
LENET_B = 64
CAFFE_STEPS = ("mnist fwd", "cifar fwd", "deploy fwd", "mnist train",
               "cifar train", "mnist direct", "cifar direct")


def caffe_kernels(torch, F, rnd, run, clock):
    """Phase 3 at LeNet's shapes, f32, batch 64: every im2col, gemm, bias
    add, maxpool and relu call of a LeNet-MNIST and a LeNet-CIFAR-10
    forward, softmax_xent at (64, 10) and softmax at (64, 10) (the deploy
    form's ``prob``) and (256, 1000); maxpool also on an input of exact
    ties, unpadded and with a pad of 1, im2col also in the registered (N,
    C*K*K, OH*OW) layout; then each new kernel once in bf16.  Yardsticks:
    ``F.unfold``, ``torch.matmul``, ``m + v``, ``F.max_pool2d`` with
    indices, ``F.leaky_relu``, ``torch.softmax`` and ``F.cross_entropy``
    with ``torch.softmax`` for the pair.  ``count``: launches per forward
    of the step.  maxpool's rows take "plane" (its bf16 row too) and are
    timed beside the strided kernel forced, a column-major CIFAR pool1
    (the transposed crossing's blob) takes "strided", as does a one-row
    band past the shared memory, one just under it "plane"; relu's take
    "vec" (a column-major CIFAR relu1 too) beside the scalar kernel
    forced, a view offset by one element "scalar"; both swept at the
    LeNet shapes (``pool_band_sweep``, ``vec_grid_sweep``).  im2col's
    rows take "band" (bf16, a 3 x 3 window and a column-major x too), a
    stride of 2 "flat"; each "band" row is bit for bit the flat kernel's
    forced and timed beside it, and swept at the five convolutions
    (``im2col_sweep``).  softmax_xent's rows take "rows" (bf16 too; the
    transposed crossing's column-major logits "strided"), are timed beside
    the strided kernel and torch's mean forced, beside the timer's pass
    over their bytes, and swept (``xent_rows_sweep``); the 64 x 10 loss
    must run one kernel a call, 256 x 1000 two (``kernels_of_call``);
    labels -1 and V inside and past the one-block cap, and a row of
    -inf, are held on both routes."""
    from repro_torch.core.container import MajorOrder, as_layout
    from repro_torch.kernels import ref
    from repro_torch.kernels.eltwise import bias_add_rows, relu
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels import im2col as IM
    from repro_torch.kernels.im2col import im2col
    from repro_torch.kernels.pooling import maxpool
    from repro_torch.kernels.softmax_xent import softmax, softmax_xent

    f32, n = torch.float32, LENET_B

    def maxpool_case(step, case, x, k, st, pad, count, route="plane"):
        """On ``route``, exact in values and argmax, timed beside the
        strided kernel forced.  Its bytes: the input that some window
        covers (the floor of the output size leaves the last rows and
        columns out), the outputs and the argmaxes."""
        nc, (h, w) = x.shape[0] * x.shape[1], x.shape[2:]
        oh, ow = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
        read = nc * min(h, (oh - 1) * st + k - pad) \
            * min(w, (ow - 1) * st + k - pad)
        outs, es = nc * oh * ow, x.element_size()
        want_route("maxpool", run(
            maxpool, f"{case} {'x'.join(map(str, x.shape))} k{k} s{st} "
            f"p{pad}", x.dtype, step, count,
            lambda: maxpool(x, k, st, pad), lambda: ref.maxpool(x, k, st, pad),
            lambda: F.max_pool2d(x, k, st, padding=pad, return_indices=True),
            read * es + outs * (es + 4), 1.0 * outs * k * k,
            forced=forced_strided_pool), route)

    def im2col_case(step, case, x, k, st, pad, count, bic, route="band"):
        """On ``route``, exact against the plain version, and on "band"
        bit for bit equal to the flat kernel forced and timed beside it.
        Its bytes: one read of x, one write of the columns."""
        n_, c_, h_, w_ = x.shape
        oh, ow = (h_ + 2 * pad - k) // st + 1, (w_ + 2 * pad - k) // st + 1
        r, o = c_ * k * k, oh * ow
        shape = f"{r}x{n_ * o}" if bic else f"{n_}x{r}x{o}"

        def kfn():
            return im2col(x, k, k, st, pad, batch_in_columns=bic)

        def pfn():
            cols = ref.im2col(x, k, k, st, pad)
            return cols.transpose(0, 1).reshape(r, -1) if bic else cols

        forced = forced_flat_im2col if route == "band" else None
        want_route("im2col", run(
            im2col, f"{case} {'x'.join(map(str, x.shape))} k{k} s{st} "
            f"p{pad} -> {shape}", x.dtype, step, count, kfn, pfn,
            lambda: F.unfold(x, k, padding=pad, stride=st),
            (x.numel() + n_ * r * o) * x.element_size(), 0.0,
            forced=forced), route)
        if forced is not None:
            equal_forced(torch, f"im2col {case}", kfn, forced)
        return kfn

    def xent_case(step, case, x, y, count, route="rows"):
        """On ``route``, probs and loss within ``TOL`` of the plain
        version, on "rows" timed beside the strided kernel and torch's
        mean forced.  Its bytes: one read of the logits and the int64
        labels, one write of the probs and the f32 loss.  No library
        yardstick where a label lies outside [0, V) (``F.cross_entropy``
        asserts on it)."""
        b, v = x.shape
        nbytes = 2 * x.element_size() * b * v + 8 * b + 4
        inside = bool(((y >= 0) & (y < v)).all())
        want_route("softmax_xent", run(
            softmax_xent, case, x.dtype, step, count,
            lambda: softmax_xent(x, y), lambda: ref.softmax_xent(x, y),
            (lambda: (F.cross_entropy(x, y), torch.softmax(x, -1)))
            if inside else None, nbytes, 5.0 * b * v,
            forced=forced_strided_xent if route == "rows" else None), route)
        return nbytes

    def relu_case(step, case, x, count, route="vec", slope=0.0):
        """On ``route``, exact, timed beside the scalar kernel forced."""
        want_route("relu", run(
            relu, f"{case} {'x'.join(map(str, x.shape))} slope {slope}",
            x.dtype, step, count, lambda: relu(x, slope),
            lambda: ref.relu(x, slope), lambda: F.leaky_relu(x, slope),
            2 * x.numel() * x.element_size(), 1.0 * x.numel(),
            forced=forced_scalar_relu), route)
        return x

    # the convolutions: (step, layer, C, H = W, F, k, pad), stride 1
    for step, layer, c, h, f, k, pad in (
            ("mnist fwd", "conv1", 1, 28, 20, 5, 0),
            ("mnist fwd", "conv2", 20, 12, 50, 5, 0),
            ("cifar fwd", "conv1", 3, 32, 32, 5, 2),
            ("cifar fwd", "conv2", 32, 15, 32, 5, 2),
            ("cifar fwd", "conv3", 32, 7, 64, 5, 2)):
        x = rnd((n, c, h, h), f32)
        r, o = c * k * k, (h + 2 * pad - k + 1) ** 2
        # the GEMM's layout (on the path), then the registered (N, R, P)
        # one (odd P at CIFAR conv2 and conv3: rows off the 16-byte grid)
        fn = im2col_case(step, layer, x, k, 1, pad, 1, True)
        im2col_case(step, layer, x, k, 1, pad, 0, False)
        timer_floor(torch, clock, f"im2col {step} {layer}", n * r * o)
        im2col_sweep(clock, "im2col", f"{step} {layer}", fn,
                     lambda x=x, k=k, pad=pad, o_sr=n * (
                         h + 2 * pad - k + 1) ** 2: IM.im2col_band(
                             f32, x.shape, k, k, 1, pad, o_sr, True))
        w = rnd((f, r), f32, r ** -0.5)
        cols = ref.im2col(x, k, k, 1, pad).transpose(0, 1).reshape(r, -1)
        want_route("gemm", run(
            gemm, f"{layer} {f}x{r} @ {r}x{n * o}", f32, step, 1,
            lambda w=w, cols=cols: gemm(w, cols),
            lambda w=w, cols=cols: ref.gemm(w, cols),
            lambda w=w, cols=cols: torch.matmul(w, cols),
            (f * r + r * n * o + f * n * o) * 4, 2.0 * f * r * n * o,
            forced=forced_skinny), SMALL_ROUTES)
        # the same product transposed, (N*OH*OW, R) x (R, F), both operands
        # read by their strides: the tiled kernel (M > SKINNY_MAX_M) in
        # place of the skinny one; not on the path (count 0), timed for
        # the gemm's redesign
        run(gemm, f"{layer} transposed {n * o}x{r} @ {r}x{f}", f32,
            "conv^T", 0, lambda w=w, cols=cols: gemm(cols.T, w.T),
            lambda w=w, cols=cols: ref.gemm(cols.T, w.T),
            lambda w=w, cols=cols: torch.matmul(cols.T, w.T),
            (f * r + r * n * o + f * n * o) * 4, 2.0 * f * r * n * o)
    # the inner products: (step, layer, K, N), then their bias adds
    for step, layer, k, out in (("mnist fwd", "ip1", 800, 500),
                                ("mnist fwd", "ip2", 500, 10),
                                ("cifar fwd", "ip1", 576, 64),
                                ("cifar fwd", "ip2", 64, 10)):
        x, w = rnd((n, k), f32), rnd((k, out), f32, k ** -0.5)
        want_route("gemm", run(
            gemm, f"{layer} {n}x{k} @ {k}x{out}", f32, step, 1,
            lambda x=x, w=w: gemm(x, w), lambda x=x, w=w: ref.gemm(x, w),
            lambda x=x, w=w: torch.matmul(x, w),
            (n * k + k * out + n * out) * 4, 2.0 * n * k * out,
            forced=forced_skinny), SMALL_ROUTES)
        # the bias: "vec" at 500 and 64, "scalar" at N = 10 (40-byte rows)
        m, v = rnd((n, out), f32), rnd((out,), f32, 0.1)
        want_route("bias_add_rows", run(
            bias_add_rows, f"{layer} {n}x{out} + {out}", f32, step, 1,
            lambda m=m, v=v: bias_add_rows(m, v),
            lambda m=m, v=v: ref.bias_add_rows(m, v),
            lambda m=m, v=v: m + v, (2 * n * out + out) * 4, 1.0 * n * out,
            forced=forced_scalar_bias), "vec" if out % 4 == 0 else "scalar")
    # the max pools: (step, case, input, k, stride, pad, count)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ties = torch.randint(-1, 2, (n, 32, 32, 32), generator=g,
                         device="cuda").float()
    for step, case, x, k, st, pad, count in (
            ("mnist fwd", "pool1", rnd((n, 20, 24, 24), f32), 2, 2, 0, 1),
            ("mnist fwd", "pool2", rnd((n, 50, 8, 8), f32), 2, 2, 0, 1),
            ("cifar fwd", "pool1", rnd((n, 32, 32, 32), f32), 3, 2, 0, 1),
            ("cifar fwd", "pool1 ties", ties, 3, 2, 0, 0),
            ("cifar fwd", "pool1 ties, pad 1", ties, 3, 2, 1, 0),
            ("mnist fwd", "pool1 ties", ties[:, :20, :24, :24], 2, 2, 0,
             0)):
        x = x.contiguous()
        maxpool_case(step, case, x, k, st, pad, count)
        if count:
            pool_band_sweep(clock, f"{step} {case}",
                            lambda x=x, k=k, st=st, pad=pad:
                            maxpool(x, k, st, pad), x, k, st, pad)
    # the transposed boundary mode's crossing: a column-major blob
    x = rnd((n, 32, 32, 32), f32)
    maxpool_case("cifar fwd", "pool1, x column-major",
                 as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN), 3, 2, 0, 0,
                 "strided")
    # one-row bands at the shared memory's edge: 47,088 bytes fit beside
    # the block's staged plane bases (kernels/pooling.py:POOL_SMEM), 48,000
    # do not and take the strided kernel
    for w, route in ((3924, "plane"), (4000, "strided")):
        maxpool_case("cifar fwd", "one-row band at the budget",
                     rnd((1, 1, 8, w), f32), 3, 1, 0, 0, route)
    # the relus: (step, case, shape)
    for step, case, shape in (("mnist fwd", "relu1", (n, 500)),
                              ("cifar fwd", "relu1", (n, 32, 15, 15)),
                              ("cifar fwd", "relu2", (n, 32, 15, 15)),
                              ("cifar fwd", "relu3", (n, 64, 7, 7))):
        x = relu_case(step, case, rnd(shape, f32), 1)
        if case != "relu2":
            vec_grid_sweep(clock, "relu", f"{step} {case}",
                           lambda x=x: relu(x), f32, x.numel())
    x = rnd((n, 32, 15, 15), f32)
    relu_case("cifar fwd", "relu1, x column-major",
              as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN), 0)
    buf = rnd((n * 500 + 1,), f32)
    relu_case("mnist fwd", "relu1, x offset by one element",
              buf[1:].view(n, 500), 0, "scalar")
    # the loss (V = 10) of both nets and the deploy form's prob, then both
    # at (256, 1000)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for step, b, v, count in (("mnist fwd", n, 10, 1),
                              ("cifar fwd", n, 10, 1),
                              ("deploy fwd", n, 10, 1),
                              ("v 1000", 256, 1000, 0)):
        x = 3 * rnd((b, v), f32)
        y = torch.randint(0, v, (b,), generator=g, device="cuda")
        if step != "deploy fwd":
            nbytes = xent_case(step, f"{b}x{v}", x, y, count)
        if step in ("mnist fwd", "v 1000"):
            # LeNet's loss is one launch (the whole batch in one block,
            # the mean fused); 256 x 1000 two, the rows then the ordered
            # sum of the blocks' partials: those kernels, each at most
            # once a call (the profiler may drop a few records)
            names = kernels_of_call(torch, lambda x=x, y=y: softmax_xent(
                x, y))
            want = {"softmax_reg_kernel"} if b == n else \
                {"softmax_reg_kernel", "xent_mean_kernel"}
            if {k.split("<")[0] for k in names} != want or any(
                    cnt > 1 for cnt, _ in names.values()):
                raise SystemExit(f"chip_smoke: softmax_xent {b}x{v}: one "
                                 f"call ran {names}, expected {want} once "
                                 "each")
            print(f"[3 kernels] softmax_xent {b}x{v} f32: one call's kernels"
                  f" (launches, device us, L2 warm) {names}", flush=True)
            timer_floor(torch, clock, f"softmax_xent {step} {b}x{v}",
                        nbytes // 4)
            xent_rows_sweep(clock, f"{b}x{v} f32", x, y, 1e-5)
        if step in ("deploy fwd", "v 1000"):
            want_route("softmax", run(
                softmax, f"{b}x{v}", f32, step, count,
                lambda x=x: softmax(x), lambda x=x: ref.softmax(x),
                lambda x=x: torch.softmax(x, -1), 8 * b * v, 4.0 * b * v,
                forced=forced_strided_softmax), "rows")
            softmax_rows_sweep(clock, f"{b}x{v} f32", x, 1e-5)
    # the transposed crossing's column-major blob takes "strided"; a row of
    # -inf gives NaN on both routes, as the plain version does
    xc = (3 * rnd((10, n), f32)).T
    want_route("softmax", run(
        softmax, f"{n}x10 column-major", f32, "off path", 0,
        lambda: softmax(xc), lambda: ref.softmax(xc),
        lambda: torch.softmax(xc, -1), 8 * n * 10, 4.0 * n * 10), "strided")
    xi = 3 * rnd((n, 10), f32)
    xi[1] = float("-inf")
    want = ref.softmax(xi)
    for how, ctx in (("rows", contextlib.nullcontext),
                     ("strided", forced_strided_softmax)):
        with ctx():
            got = softmax(xi)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        if not (torch.equal(torch.isnan(got), nan) and nan[1].all()
                and (got[~nan] - want[~nan]).abs().max().item() <= 1e-5):
            raise SystemExit(f"chip_smoke: softmax on {how}: a row of -inf "
                             "is not NaN as in the plain version, or the "
                             "other rows disagree")
    print("[3 kernels] softmax: a row of -inf gives NaN on rows and strided, "
          "as the plain version", flush=True)
    # the loss off the path (counts 0): the transposed crossing's
    # column-major logits take "strided"; labels -1 and V give their rows
    # an NLL of 0 and the mean still divides by B, past the one-block cap
    # too (65 rows: the blocks' partials, then their ordered sum); a row
    # of -inf gives NaN probs and a NaN loss on both routes
    y = torch.randint(0, 10, (n,), generator=g, device="cuda")
    xent_case("off path", f"{n}x10 column-major", xc, y, 0, "strided")
    for rows in (n, n + 1):
        xo = 3 * rnd((rows, 10), f32)
        yo = torch.randint(0, 10, (rows,), generator=g, device="cuda")
        yo[0], yo[1] = -1, 10
        xent_case("off path", f"{rows}x10 labels -1 and V", xo, yo, 0)
    yi = torch.randint(0, 10, (n,), generator=g, device="cuda")
    want_l, want_p = ref.softmax_xent(xi, yi)
    for how, ctx in (("rows", contextlib.nullcontext),
                     ("strided", forced_strided_xent)):
        with ctx():
            got_l, got_p = softmax_xent(xi, yi)
        torch.cuda.synchronize()
        nan = torch.isnan(want_p)
        if not (torch.isnan(got_l).item() and torch.isnan(want_l).item()
                and torch.equal(torch.isnan(got_p), nan) and nan[1].all()
                and (got_p[~nan] - want_p[~nan]).abs().max().item()
                <= 1e-5):
            raise SystemExit(f"chip_smoke: softmax_xent on {how}: a row of "
                             "-inf does not give NaN as in the plain "
                             "version, or the other rows disagree")
    print("[3 kernels] softmax_xent: a row of -inf gives NaN probs and a NaN"
          " loss on rows and strided, as the plain version", flush=True)
    # each new kernel once in bf16 (LeNet runs f32), counts 0
    bf = torch.bfloat16
    im2col_case("bf16", "conv1", rnd((n, 1, 28, 28), bf), 5, 1, 0, 0, True)
    im2col_case("bf16", "conv2", rnd((n, 32, 15, 15), bf), 5, 1, 2, 0,
                True)
    # off the LeNet path (counts 0): a 3 x 3 window, a stride-2 window
    # (the flat kernel), and the transposed crossing's column-major x
    # (staged by its strides)
    im2col_case("off-path", "3x3", rnd((8, 16, 30, 30), f32), 3, 1, 1, 0,
                True)
    im2col_case("off-path", "stride 2", rnd((8, 16, 30, 30), f32), 3, 2, 1,
                0, True, route="flat")
    im2col_case("off-path", "conv2 x column-major", as_layout(
        rnd((n, 32, 15, 15), f32), MajorOrder.ROW, MajorOrder.COLUMN), 5, 1,
        2, 0, True)
    maxpool_case("bf16", "pool1", rnd((n, 20, 24, 24), bf), 2, 2, 0, 0)
    relu_case("bf16", "relu1", rnd((n, 500), bf), 0, slope=0.1)
    x = 3 * rnd((n, 10), bf)
    y = torch.randint(0, 10, (n,), generator=g, device="cuda")
    xent_case("bf16", f"{n}x10", x, y, 0)
    want_route("softmax", run(
        softmax, f"{n}x10", bf, "bf16", 0, lambda: softmax(x),
        lambda: ref.softmax(x), lambda: torch.softmax(x, -1), 4 * n * 10,
        4.0 * n * 10, forced=forced_strided_softmax), "rows")
    softmax_rows_sweep(clock, f"{n}x10 bf16", x, 2 ** -7)
    x = 3 * rnd((256, 1000), bf)
    xent_case("bf16", "256x1000", x, torch.randint(
        0, 1000, (256,), generator=g, device="cuda"), 0)
    want_route("softmax", run(
        softmax, "256x1000", bf, "bf16", 0, lambda: softmax(x),
        lambda: ref.softmax(x), lambda: torch.softmax(x, -1),
        4 * 256 * 1000, 4.0 * 256 * 1000, forced=forced_strided_softmax),
        "rows")
    softmax_rows_sweep(clock, "256x1000 bf16", x, 2 ** -7)


def caffe_train_kernels(torch, F, rnd, run, clock):
    """Phase 3 at the Caffe backward's shapes, f32, batch 64: every
    col2im, maxpool_bwd, relu_bwd and softmax_xent_bwd launch and every
    backward gemm of a LeNet-MNIST and a LeNet-CIFAR-10 train step
    (``count``: launches per step beyond the forward's, whose im2col the
    backward repeats), col2im on the backward product's strided view and
    on contiguous (N, C*K*K, OH*OW) columns, maxpool_bwd on exact ties
    with pads 0 and 1, softmax_xent_bwd with the cotangent folded in (g =
    1 on the path; g = 1.7, labels -1 and V, 256 x 1000, a column-major
    probs and a base off 16 bytes off it), CIFAR's two average-pool
    backwards (aten's gather against the window gather's autograd); then
    each new kernel once in bf16.  softmax_xent_bwd's rows take "rows"
    (the two off-layout ones "strided"), each bit for bit the composition
    it replaced (the first kernel, then torch's ``* g``) forced and timed
    beside it; the 64 x 10 backward must run one kernel a call
    (``kernels_of_call``).  relu_bwd's rows are timed beside the strided
    kernel forced, and its vec kernel swept over ``relu_vec_grid``'s
    block caps (``vec_grid_sweep``); col2im's take "tile" (the registered
    layout at an odd P, bf16 and a 3 x 3 window too), each bit for bit the
    flat kernel's forced and timed beside it, swept at its three LeNet
    shapes (``im2col_sweep``); maxpool_bwd's take "window" (ties, pad 1,
    a 3/3 pool, a 2/3 pool at pad 1, a row of no whole vectors, bf16),
    each bit for bit the pixel kernel's forced and timed beside it, swept
    at MNIST's two pools (``pool_bwd_sweep``) beside the timer's pass
    over their bytes; a column-major dy and a stride of 4 take "pixel".
    Yardsticks:
    ``F.fold``, the backward of ``F.max_pool2d(return_indices=True)``
    (``aten.max_pool2d_with_indices_backward``), of ``F.leaky_relu``
    (``aten.leaky_relu_backward``) and of ``F.cross_entropy`` (autograd
    through its graph), ``torch.matmul``."""
    from repro_torch.core.container import MajorOrder, as_layout
    from repro_torch.kernels import ref
    from repro_torch.kernels.eltwise import relu_bwd
    from repro_torch.kernels import im2col as IM
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.im2col import col2im
    from repro_torch.kernels.pooling import maxpool, maxpool_bwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.softmax_xent import softmax_xent_bwd

    f32, bf, n = torch.float32, torch.bfloat16, LENET_B
    aten = torch.ops.aten

    def col2im_case(step, case, c, h, k, pad, count, dtype=f32,
                    strided=True):
        r, oh = c * k * k, h + 2 * pad - k + 1
        p = oh * oh
        es = torch.tensor([], dtype=dtype).element_size()
        cols3 = rnd((n, r, p), dtype)            # the (N, R, P) layout
        # the convolution backward's (R, N*P) product, read as (N, R, P)
        # through a transposed view
        wide = cols3.transpose(0, 1).reshape(r, n * p)
        cols = wide.view(r, n, p).transpose(0, 1) if strided else cols3
        shape = (n, c, h, h)
        # the (o, i) pairs of an axis with 0 <= o + i - pad < h: a tap in
        # the padding is read neither by the function nor by the kernel
        taps = sum(0 <= o + i - pad < h for o in range(oh) for i in range(k))

        def kfn():
            return col2im(cols, shape, k, k, 1, pad)

        want_route("col2im", run(
            col2im, f"{case} {'x'.join(map(str, cols.shape))}"
            f"{' strided' if strided else ''} -> {n}x{c}x{h}x{h} k{k} "
            f"p{pad}", dtype, step, count, kfn,
            lambda: ref.col2im(cols3.float(), shape, k, k, 1, pad).to(dtype),
            lambda: F.fold(cols3, (h, h), k, padding=pad),
            (n * c * taps * taps + n * c * h * h) * es,
            1.0 * n * c * taps * taps, forced=forced_flat_col2im), "tile")
        equal_forced(torch, f"col2im {case}", kfn, forced_flat_col2im)
        return kfn

    def maxpool_bwd_case(step, case, x, k, st, pad, count, route="window",
                         dy_column_major=False):
        """On ``route``, exact against the plain version, and on "window"
        bit for bit equal to the pixel kernel forced and timed beside it.
        Its bytes: one read of dy and the argmax, one write of the
        image.  Returns the call and its bytes."""
        dtype = x.dtype
        es = x.element_size()
        out, arg = maxpool(x, k, st, pad)
        dy = rnd(tuple(out.shape), dtype)
        if dy_column_major:
            dy = as_layout(dy, MajorOrder.ROW, MajorOrder.COLUMN)
        _, idx = F.max_pool2d(x, k, st, padding=pad, return_indices=True)
        shape = tuple(x.shape)

        def kfn():
            return maxpool_bwd(dy, arg, shape, k, st, pad)

        forced = forced_pixel_pool_bwd if route == "window" else None
        nbytes = dy.numel() * (es + 4) + x.numel() * es
        want_route("maxpool_bwd", run(
            maxpool_bwd, f"{case} {'x'.join(map(str, dy.shape))} -> "
            f"{'x'.join(map(str, shape))} k{k} s{st} p{pad}", dtype, step,
            count, kfn, lambda: ref.maxpool_bwd(dy, arg, shape, k, st, pad),
            lambda: aten.max_pool2d_with_indices_backward(
                dy, x, [k, k], [st, st], [pad, pad], [1, 1], False, idx),
            nbytes, 0.0, forced=forced), route)
        if forced is not None:
            equal_forced(torch, f"maxpool_bwd {case}", kfn, forced)
        return kfn, nbytes

    def relu_bwd_case(step, case, shape, count, dtype=f32, slope=0.0,
                      x_column_major=False):
        """On the vec kernel where x and dy share a layout, the strided
        one for a column-major x with a row-major dy; timed beside the
        strided kernel forced (``forced_strided``)."""
        x, dy = rnd(shape, dtype), rnd(shape, dtype)
        if x_column_major:
            # the transposed boundary mode's x meets a row-major dy
            perm = tuple(reversed(range(len(shape))))
            x = x.permute(perm).contiguous().permute(perm)
        want_route("relu_bwd", run(
            relu_bwd, f"{case} {'x'.join(map(str, shape))} slope {slope}",
            dtype, step, count, lambda: relu_bwd(x, dy, slope),
            lambda: ref.relu_bwd(x, dy, slope),
            lambda: aten.leaky_relu_backward(dy, x, slope, False),
            3 * x.numel() * x.element_size(), 1.0 * x.numel(),
            forced=forced_strided),
            "strided" if x_column_major else "vec")
        return x, dy

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def xent_bwd_case(step, case, count, dtype=f32, rows=n, v=10, cot=1.0,
                      outside=False, layout=None, route="rows"):
        """The loss's backward with the cotangent ``cot`` folded in, on
        ``route``: within ``TOL`` of the plain version
        (``ref.softmax_xent_bwd(p, y) * g``) and bit for bit the
        composition it replaced (the first kernel without g, then torch's
        ``* g``: ``forced_twostep_xent_bwd``), timed beside it.
        ``layout``: "column-major" probs, or a base "off 16 bytes" (both
        "strided").  Its bytes: one read of p, the int64 labels and g, one
        write of the gradient.  Returns the call and its bytes."""
        es = torch.tensor([], dtype=dtype).element_size()
        p = torch.softmax(3 * rnd((rows, v), f32), -1).to(dtype)
        if layout == "column-major":
            p = p.T.contiguous().T
        elif layout == "off 16 bytes":
            buf = torch.empty(rows * v + 1, dtype=dtype, device="cuda")
            buf[1:].copy_(p.reshape(-1))
            p = buf[1:].view(rows, v)
        y = torch.randint(0, v, (rows,), generator=g, device="cuda")
        if outside:
            y[0], y[1] = -1, v
        gt = torch.tensor(cot, device="cuda")
        lfn = None
        if not outside:
            leaf = (3 * rnd((rows, v), dtype)).requires_grad_(True)
            loss = F.cross_entropy(leaf, y)
            lfn = lambda: torch.autograd.grad(loss, leaf, gt,  # noqa: E731
                                              retain_graph=True)

        def kfn():
            return xent_bwd_of(p, y, gt)

        nbytes = 2 * rows * v * es + 8 * rows + 4
        want_route("softmax_xent_bwd", run(
            softmax_xent_bwd, f"{case} {rows}x{v}"
            f"{f' g {cot}' if cot != 1.0 else ''}"
            f"{f' {layout}' if layout else ''}", dtype, step, count, kfn,
            lambda: ref.softmax_xent_bwd(p, y) * gt, lfn, nbytes,
            3.0 * rows * v, forced=forced_twostep_xent_bwd), route)
        equal_forced(torch, f"softmax_xent_bwd {case}", kfn,
                     forced_twostep_xent_bwd)
        return kfn, nbytes

    def avgpool_bwd():
        """Names phase 3's rows of the average pool's backward, which is
        aten's (avgpool has no TPU kernel, so none of the port's)."""

    def avgpool_bwd_case(step, case, c, h, count, k=3, st=2):
        """CIFAR's average pool's backward through ``torch.autograd.grad``:
        ``AvgPoolFn``'s (aten's ``avg_pool2d_backward``, a gather per input
        pixel, one launch) against the backward it replaced, autograd of
        ``ref.avgpool``'s window gather (``index_put_`` with accumulation:
        a sort, then ``indexing_backward_kernel``; ``forced_windows_
        avgpool``), within 1e-6 (up to 4 windows' terms in another
        order); the library yardstick aten's call alone.  Its bytes: one
        read of the cotangent, one write of dx."""
        x = rnd((n, c, h, h), f32).requires_grad_(True)
        out = ops.avgpool(x, k, st)
        if type(out.grad_fn).__name__ != "AvgPoolFnBackward":
            raise SystemExit(f"chip_smoke: avgpool {case}: took "
                             f"{type(out.grad_fn).__name__}")
        with forced_windows_avgpool():
            old = ops.avgpool(x, k, st)
        dy = rnd(tuple(out.shape), f32)
        run(avgpool_bwd, f"{case} {n}x{c}x{h}x{h} k{k} s{st}", f32, step,
            count, lambda: torch.autograd.grad(out, x, dy,
                                               retain_graph=True)[0],
            lambda: torch.autograd.grad(old, x, dy, retain_graph=True)[0],
            lambda: aten.avg_pool2d_backward(dy, x.detach(), (k, k),
                                             (st, st), (0, 0), False, True,
                                             k * k),
            4 * (dy.numel() + x.numel()), 1.0 * dy.numel() * k * k,
            tol=1e-6)

    def gemm_case(step, case, a, b, count, route):
        """``route``: the one ``plan`` must pick; the f32 small-M route's
        products with A read along K are timed on the skinny kernel too."""
        m, kk = a.shape
        nn = b.shape[1]
        want_route("gemm", run(
            gemm, f"{case} {m}x{kk} @ {kk}x{nn}", f32, step, count,
            lambda: gemm(a, b), lambda: ref.gemm(a, b),
            lambda: torch.matmul(a, b),
            (m * kk + kk * nn + m * nn) * 4, 2.0 * m * nn * kk,
            forced=(forced_skinny if route == SMALL_ROUTES
                    and a.stride(1) == 1 else None)), route)

    # col2im: (step, case, C, H, k, pad) of each convolution whose input
    # needs a gradient (conv1 reads the data)
    for step, case, c, h, k, pad in (("mnist train", "conv2", 20, 12, 5, 0),
                                     ("cifar train", "conv2", 32, 15, 5, 2),
                                     ("cifar train", "conv3", 32, 7, 5, 2)):
        fn = col2im_case(step, case, c, h, k, pad, 1)
        timer_floor(torch, clock, f"col2im {step} {case}",
                    n * c * k * k * (h + 2 * pad - k + 1) ** 2)
        im2col_sweep(clock, "col2im", f"{step} {case}", fn,
                     lambda c=c, h=h: IM.col2im_tile((n, c, h, h)))
    col2im_case("mnist train", "conv2", 20, 12, 5, 0, 0, strided=False)
    # the registered (N, C*K*K, OH*OW) layout at CIFAR conv2's odd P, and
    # a 3 x 3 window off the LeNet path (counts 0)
    col2im_case("cifar train", "conv2", 32, 15, 5, 2, 0, strided=False)
    col2im_case("off-path", "3x3", 16, 30, 3, 1, 0)
    # maxpool_bwd: MNIST's two 2/2 pools (CIFAR's 3/2 pool1 overlaps and
    # takes the plain scatter), then ties with pads 0 and 1
    ties = torch.randint(-1, 2, (n, 20, 24, 24), generator=g,
                         device="cuda").float()
    for case, x, pad, count in (("pool1", rnd((n, 20, 24, 24), f32), 0, 1),
                                ("pool2", rnd((n, 50, 8, 8), f32), 0, 1),
                                ("pool1 ties", ties, 0, 0),
                                ("pool1 ties, pad 1", ties, 1, 0)):
        fn, nbytes = maxpool_bwd_case("mnist train", case, x, 2, 2, pad,
                                      count)
        if count:
            timer_floor(torch, clock, f"maxpool_bwd mnist train {case}",
                        nbytes // 4)
            pool_bwd_sweep(clock, f"mnist train {case}", fn, f32,
                           tuple(x.shape), 2, 0)
    # off the LeNet path (counts 0): a 3/3 pool of CIFAR's pool1 input, a
    # 2/3 pool with a gap between windows at pad 1 and odd H and W, a row
    # of no whole vectors (stored element by element), all on "window";
    # a column-major dy and a stride of 4 on "pixel"
    maxpool_bwd_case("off-path", "k3 s3", rnd((n, 32, 32, 32), f32), 3, 3,
                     0, 0)
    maxpool_bwd_case("off-path", "k2 s3 p1", rnd((n, 20, 23, 23), f32), 2,
                     3, 1, 0)
    maxpool_bwd_case("off-path", "W 25", rnd((n, 20, 24, 25), f32), 2, 2,
                     0, 0)
    maxpool_bwd_case("off-path", "dy column-major", rnd((n, 20, 24, 24),
                                                        f32), 2, 2, 0, 0,
                     route="pixel", dy_column_major=True)
    maxpool_bwd_case("off-path", "k4 s4", rnd((n, 20, 24, 24), f32), 4, 4,
                     0, 0, route="pixel")
    # relu_bwd: (step, case, shape, count)
    for step, case, shape, count in (
            ("mnist train", "relu1", (n, 500), 1),
            ("cifar train", "relu1,relu2", (n, 32, 15, 15), 2),
            ("cifar train", "relu3", (n, 64, 7, 7), 1)):
        x, dy = relu_bwd_case(step, case, shape, count)
        vec_grid_sweep(clock, "relu_bwd", f"{step} {case}",
                       lambda x=x, dy=dy: relu_bwd(x, dy), f32, x.numel())
    relu_bwd_case("cifar train", "relu3, x column-major", (n, 64, 7, 7), 0,
                  x_column_major=True)
    # the loss's backward (V = 10) of both nets, g = 1 as a train step
    # gives it; then off the path (counts 0): g = 1.7, labels -1 and V,
    # 256 x 1000, a column-major probs and a base off 16 bytes ("strided")
    fn, nbytes = xent_bwd_case("mnist train", "loss", 1)
    xent_bwd_case("cifar train", "loss", 1)
    # one launch a call, the gradient and g's multiply in one kernel (the
    # composition it replaced: two); each kernel at most once a call (the
    # profiler may drop a few records)
    names = kernels_of_call(torch, fn)
    if {k.split("<")[0] for k in names} != {"xent_bwd_reg_kernel"} or any(
            cnt > 1 for cnt, _ in names.values()):
        raise SystemExit(f"chip_smoke: softmax_xent_bwd {n}x10: one call ran "
                         f"{names}, expected xent_bwd_reg_kernel once")
    with forced_twostep_xent_bwd():
        was = kernels_of_call(torch, fn)
    print(f"[3 kernels] softmax_xent_bwd {n}x10 f32: one call's kernels "
          f"(launches, device us, L2 warm) {names}; the composition it "
          f"replaced {was}", flush=True)
    timer_floor(torch, clock, f"softmax_xent_bwd mnist train {n}x10",
                nbytes // 4)
    xent_bwd_case("mnist train", "loss", 0, cot=1.7)
    xent_bwd_case("mnist train", "labels -1 and V", 0, cot=1.7,
                  outside=True)
    xent_bwd_case("v 1000", "loss", 0, rows=256, v=1000, cot=1.7)
    xent_bwd_case("off path", "loss", 0, cot=1.7, layout="column-major",
                  route="strided")
    xent_bwd_case("off path", "loss", 0, cot=1.7, layout="off 16 bytes",
                  route="strided")
    # CIFAR's two 3/2 average pools (pool2 on conv2's 32 x 15 x 15, pool3 on
    # conv3's 64 x 7 x 7)
    avgpool_bwd_case("cifar train", "pool2", 32, 15, 1)
    avgpool_bwd_case("cifar train", "pool3", 64, 7, 1)
    # the backward products: the convolutions' dw = dy_flat @ cols^T (M = F,
    # K = N*OH*OW, B read along K) and dcols = w_mat^T @ dy_flat (A read
    # along M), the inner products' da = g @ W^T (B along K) and db = x^T
    # @ g (A along M); conv1 has no dcols
    for step, case, f, c, o, k, dx in (
            ("mnist train", "conv1", 20, 1, 24, 5, False),
            ("mnist train", "conv2", 50, 20, 8, 5, True),
            ("cifar train", "conv1", 32, 3, 32, 5, False),
            ("cifar train", "conv2", 32, 32, 15, 5, True),
            ("cifar train", "conv3", 64, 32, 7, 5, True)):
        r, cols_n = c * k * k, n * o * o
        dy_flat = rnd((f, cols_n), f32)
        cols = rnd((r, cols_n), f32)
        w = rnd((f, r), f32, r ** -0.5)
        gemm_case(step, f"{case} dw", dy_flat, cols.T, 1, SMALL_ROUTES)
        if dx:
            gemm_case(step, f"{case} dcols", w.T, dy_flat, 1, "tiled")
    for step, case, k, out in (("mnist train", "ip1", 800, 500),
                               ("mnist train", "ip2", 500, 10),
                               ("cifar train", "ip1", 576, 64),
                               ("cifar train", "ip2", 64, 10)):
        x, w, gr = rnd((n, k), f32), rnd((k, out), f32, k ** -0.5), \
            rnd((n, out), f32)
        gemm_case(step, f"{case} da", gr, w.T, 1, SMALL_ROUTES)
        # db reads x.T along M: the small-M kernel at M = K <= 64
        gemm_case(step, f"{case} db", x.T, gr, 1,
                  SMALL_ROUTES if k <= 64 else "tiled")
    # each new kernel once in bf16 (LeNet trains in f32), counts 0
    col2im_case("bf16", "conv2", 20, 12, 5, 0, 0, dtype=bf)
    maxpool_bwd_case("bf16", "pool1", rnd((n, 20, 24, 24), bf), 2, 2, 0, 0)
    maxpool_bwd_case("bf16", "pool2", rnd((n, 50, 8, 8), bf), 2, 2, 0, 0)
    relu_bwd_case("bf16", "relu1", (n, 500), 0, dtype=bf, slope=0.1)
    xent_bwd_case("bf16", "loss", 0, dtype=bf)
    xent_bwd_case("bf16", "loss", 0, dtype=bf, cot=1.7, outside=True)
    xent_bwd_case("bf16", "loss", 0, dtype=bf, rows=256, v=1000, cot=1.7)


def small_gemm_cases(torch, rnd, run, clock):
    """Phase 3 for the f32 small-M kernel off the LeNet shapes (count 0),
    each held to the plain version and timed beside ``torch.matmul`` and,
    with A read along K, the skinny kernel: ragged M and N in both B
    layouts, the unaligned 100- and 300-byte rows of K = 25 and 75 (4-byte
    copies) with an unaligned B, a B read along K whose row stride is odd,
    A read along M (aligned, unaligned, split), and a split whose last
    slice is 5 of K.  Then qwen2.5-3b's f32 decode (M = 4) and prefill (M =
    64) products on the skinny kernel, which keeps them, against the
    small-M kernel forced onto them (``SMALL_MAX_SPAN`` raised): where
    ``SMALL_MAX_SPAN`` stands."""
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm import gemm

    f32 = torch.float32
    cases = [
        ("ragged 37x300 @ 300x1000", rnd((37, 300), f32),
         rnd((300, 1000), f32)),
        ("ragged NT 45x5003 @ (1003x5003).T", rnd((45, 5003), f32),
         rnd((1003, 5003), f32).T),
        ("K=25 rows 20x25 @ 25x1001, ldb 1001", rnd((20, 25), f32),
         rnd((25, 1001), f32)),
        ("K=75 rows 32x75 @ 75x4003, ldb 4003", rnd((32, 75), f32),
         rnd((75, 4003), f32)),
        ("NT ldb 5003: 20x5003 (lda 5004) @ (25x5003).T",
         rnd((20, 5004), f32)[:, :5003], rnd((25, 5003), f32).T),
        ("A(M) x.T 40x300 @ 300x77", rnd((300, 40), f32).T,
         rnd((300, 77), f32)),
        ("A(M) lda 37 x.T 37x300 @ (77x300).T", rnd((300, 37), f32).T,
         rnd((77, 300), f32).T),
        ("A(M) x.T 64x3000 @ 3000x64", rnd((3000, 64), f32).T,
         rnd((3000, 64), f32)),
        ("short last slice 20x36869 @ (25x36869).T", rnd((20, 36869), f32),
         rnd((25, 36869), f32).T)]
    for case, a, b in cases:
        m, k = a.shape
        n = b.shape[1]
        p = gemm_mod.plan(m, n, k, f32, a_m_contiguous=a.stride(1) != 1,
                          b_k_contiguous=b.stride(1) != 1, tc_aligned=False)
        last = k - (p.splits - 1) * p.slice_k
        route = run(gemm, f"{case} ({p.splits} x {p.slice_k}, last {last})",
                    f32, "f32 small", 0, lambda a=a, b=b: gemm(a, b),
                    lambda a=a, b=b: ref.gemm(a, b),
                    lambda a=a, b=b: torch.matmul(a, b),
                    (m * k + k * n + m * n) * 4, 2.0 * m * n * k,
                    forced=forced_skinny if a.stride(1) == 1 else None)
        want_route("gemm", route, p.route)
        want_route("gemm", route, SMALL_ROUTES)
        if case.startswith("short") and not 0 < last < p.slice_k:
            raise SystemExit(f"chip_smoke: gemm {case}: no short last "
                             "slice")
    del cases
    d, d_ff, vocab = 2048, 11008, 151936
    for m in (4, 64):
        total = [0.0, 0.0]
        for name, k, n, nt, count in (("wq,wo", d, d, False, 72),
                                      ("wk,wv", d, 256, False, 72),
                                      ("wg,wi", d, d_ff, False, 72),
                                      ("wo", d_ff, d, False, 36),
                                      ("head (NT)", d, vocab, True, 1)):
            x = rnd((m, k), f32)
            w = (rnd((n, k), f32, 0.02).T if nt
                 else rnd((k, n), f32, k ** -0.5))
            ms = []
            for span in (gemm_mod.SMALL_MAX_SPAN, 2 ** 31):
                saved, gemm_mod.SMALL_MAX_SPAN = gemm_mod.SMALL_MAX_SPAN, span
                try:
                    before = dict(gemm_mod.gemm.routes)
                    got = gemm(x, w)
                    route = [r for r, c in gemm_mod.gemm.routes.items()
                             if c != before[r]][0]
                    want_route("gemm", route, "skinny" if len(ms) == 0
                               else SMALL_ROUTES)
                    want = ref.gemm(x, w)
                    err = (got - want).abs().max().item()
                    if not err <= 1e-5 * want.abs().max().item():
                        raise SystemExit(f"chip_smoke: gemm {route} {name} "
                                         f"M={m}: max_abs_err {err:.3g}")
                    ms.append(clock(lambda x=x, w=w: gemm(x, w)))
                finally:
                    gemm_mod.SMALL_MAX_SPAN = saved
                total[len(ms) - 1] += count * ms[-1]
            print(f"[3 kernels] gemm f32 small-M vs skinny {name} "
                  f"{m}x{k} @ {k}x{n}: skinny {ms[0]:.4f} ms, {route} "
                  f"{ms[1]:.4f} ms", flush=True)
            del x, w, got, want
        print(f"[3 kernels] gemm f32 small-M vs skinny M={m}: one "
              f"qwen2.5-3b forward's products (36 layers and the head): "
              f"skinny {total[0]:.3f} ms, small-M {total[1]:.3f} ms "
              f"(SMALL_MAX_SPAN {gemm_mod.SMALL_MAX_SPAN} keeps the skinny "
              f"kernel)", flush=True)


# the five LeNet convolutions at batch 64, stride 1: (net, layer, C, H = W,
# F, k, pad); the pools round their output size down (CIFAR's 3/2 pools:
# 32 -> 15 -> 7)
LENET_CONVS = (("mnist", "conv1", 1, 28, 20, 5, 0),
               ("mnist", "conv2", 20, 12, 50, 5, 0),
               ("cifar", "conv1", 3, 32, 32, 5, 2),
               ("cifar", "conv2", 32, 15, 32, 5, 2),
               ("cifar", "conv3", 32, 7, 64, 5, 2))


def direct_kernels(torch, F, rnd, run, clock):
    """Phase 3 for conv2d_direct, held to ``ref.conv2d_direct``: JAX's
    cases (``tests/test_kernels_conv_direct.py``: strides 1-3, pads 0-2,
    2x2 windows, F = 160 with C = 3, and its case without bias), the
    autotuner's ``conv3x3`` cell (``repro/tuning/autotune.py:123-136``),
    rows wider than a reg tile (OW 48 and 36, whose last column tile
    overhangs the row; f32 and bf16), the five LeNet convolutions at batch 64 in f32 (``count`` 1 in the
    step of their net's forward convolutions, as phase 10 runs them), then
    CIFAR conv2 in bf16 and MNIST conv2 on a channels-last x (a view read
    by its strides).  Yardsticks: ``F.conv2d`` (cuDNN, TF32 off) and the
    port's im2col + gemm form (``ops.conv2d_hopper``).  Each row takes the
    route ``plan`` names ("reg" for 3 x 3 and 5 x 5 windows at stride 1,
    else "scalar") and is timed beside the scalar kernel forced
    (``forced_scalar_conv``); the LeNet rows' reg kernel is swept over
    ``tiles``' caps (``conv_tile_sweep``)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.conv_direct import conv2d_direct, cost, plan

    f32, bf = torch.float32, torch.bfloat16
    cases = [("jax cases", "jax", n, c, h, f, k, s, p, f32, True, False, 0)
             for n, c, h, f, k, s, p in (
                 (2, 3, 12, 4, 3, 1, 1), (1, 1, 28, 20, 5, 1, 0),
                 (2, 4, 10, 8, 3, 2, 1), (1, 2, 8, 3, 2, 2, 0),
                 (2, 3, 9, 5, 3, 3, 0), (1, 3, 16, 160, 5, 1, 2))]
    cases += [("jax cases", "jax no bias", 2, 3, 8, 4, 3, 1, 1, f32, False,
               False, 0),
              ("tuning", "conv3x3", 2, 8, 16, 64, 3, 1, 1, f32, True, False,
               0)]
    # rows wider than a reg tile's 32 columns and no multiple of them: the
    # last column tile's strips overhang the row (f32 stores whole strips)
    cases += [("wide rows", what, 8, c, h, f, k, 1, p, dt, True, False, 0)
              for what, c, h, f, k, p, dt in (
                  ("3x3 ow 48", 8, 48, 16, 3, 1, f32),
                  ("5x5 ow 36", 4, 36, 8, 5, 2, f32),
                  ("3x3 ow 48 bf16", 8, 48, 16, 3, 1, bf))]
    cases += [(f"{net} direct", layer, LENET_B, c, h, f, k, 1, p, f32, True,
               False, 1) for net, layer, c, h, f, k, p in LENET_CONVS]
    cases += [("bf16", "cifar conv2", LENET_B, 32, 15, 32, 5, 1, 2, bf, True,
               False, 0),
              ("layout", "mnist conv2 channels-last", LENET_B, 20, 12, 50, 5,
               1, 0, f32, True, True, 0)]
    for step, what, n, c, h, f, k, st, p, dt, bias, cl, count in cases:
        x = (rnd((n, h, h, c), dt).permute(0, 3, 1, 2) if cl
             else rnd((n, c, h, h), dt))
        w = rnd((f, c, k, k), dt, (c * k * k) ** -0.5)
        b = rnd((f,), dt, 0.1) if bias else None
        nbytes, flops, _ = cost(x.shape, w.shape, st, p, x.element_size(),
                                bias)

        def fn(x=x, w=w, b=b, st=st, p=p):
            return conv2d_direct(x, w, b, stride=st, pad=p)

        want_route("conv2d_direct", run(
            conv2d_direct, f"{what} {n}x{c}x{h}x{h} -> {f} k{k} s{st} p{p}",
            dt, step, count, fn,
            lambda x=x, w=w, b=b, st=st, p=p: ref.conv2d_direct(
                x, w, b, stride=st, pad=p),
            lambda x=x, w=w, b=b, st=st, p=p: F.conv2d(
                x, w, b, stride=st, padding=p),
            nbytes, flops,
            im2col_gemm=lambda x=x, w=w, b=b, st=st, p=p: ops.conv2d_hopper(
                x, w, b, stride=st, pad=p), forced=forced_scalar_conv),
            plan(dt, x.shape, w.shape, st, p))
        if count:
            conv_tile_sweep(clock, f"{step} {what}", fn, x, w, st, p)


# ---------------------------------------------------------------------------
# phase 4: full-width serving through the port's engine
# ---------------------------------------------------------------------------

def perturb(torch, params, seed: int) -> None:
    """Non-zero qkv biases, non-unit norm weights and, in the Mamba blocks,
    non-trivial decay, step bias and skip (the JAX init sets them to 0, 1,
    a_log = dt_bias = 0 and d_skip = 1, which would leave the bias kernel,
    the weight multiply and the per-head decay untested)."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)

    def noise(t, scale):
        return (torch.randn(t.shape, generator=gen, device=t.device)
                * scale).to(t.dtype)

    def attn_mlp(attn, mlp):
        """``mlp``: the MLP, or the MoE block (its norm before the
        router)."""
        for key in ("bq", "bk", "bv"):
            if key in attn:
                attn[key] = noise(attn[key], 0.05)
        for blk in (attn, mlp):
            blk["ln"] = blk["ln"] + noise(blk["ln"], 0.1)

    def mamba(m):
        for key, scale in (("a_log", 0.5), ("dt_bias", 0.5),
                           ("d_skip", 0.1), ("ln", 0.1), ("ln_inner", 0.1)):
            m[key] = m[key] + noise(m[key], scale)

    params["ln_f"] = params["ln_f"] + noise(params["ln_f"], 0.1)
    layers = params.get("layers", []) + [
        p for group in params.get("groups", []) for p in group]
    for p in layers:
        if "attn" in p:
            attn_mlp(p["attn"], p["mlp"] if "mlp" in p else p["moe"])
        else:
            mamba(p["mamba"])
    if "shared_attn" in params:
        attn_mlp(params["shared_attn"], params["shared_mlp"])


def requests(n, lo, hi, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


KERNELS = ("gemm", "rmsnorm", "bias_add_rows", "flash_decode",
           "flash_decode_paged", "flash_prefill_chunk",
           "flash_prefill_chunk_paged", "flash_decode_paged_quant",
           "flash_prefill_chunk_paged_quant", "flash_attention", "ssd_scan",
           "rmsnorm_bwd", "flash_attention_bwd", "im2col", "maxpool", "relu",
           "softmax", "softmax_xent", "col2im", "maxpool_bwd", "relu_bwd",
           "softmax_xent_bwd", "conv2d_direct")
# the attention kernels of each (layout, pool): (decode step, prefill step)
ATTN = {("contiguous", "f32"): ("flash_decode", "flash_prefill_chunk"),
        ("paged", "f32"): ("flash_decode_paged", "flash_prefill_chunk_paged"),
        ("paged", "bf16"): ("flash_decode_paged",
                            "flash_prefill_chunk_paged"),
        ("paged", "int8"): ("flash_decode_paged_quant",
                            "flash_prefill_chunk_paged_quant")}
PAGE, CHUNK, GEN_LEN, MAX_LEN = 16, 16, 32, 128
# mixtral-8x7b's 32 layers hold 93 GB of bf16 weights: 16 fit the card
MOE_LAYERS = 16
# the serving paths of each arch, (layout, prefill chunk, kv_dtype), in run
# order ("f32" is the model's own dtype, here bf16); mamba2-2.7b has no KV
# cache, so its layout is moot
PATHS = {"qwen2.5-3b": (("paged", CHUNK, "f32"), ("contiguous", 1, "f32"),
                        ("contiguous", CHUNK, "f32"),
                        ("paged", CHUNK, "int8")),
         "mamba2-2.7b": (("contiguous", 1, "f32"),
                         ("contiguous", CHUNK, "f32")),
         "zamba2-2.7b": (("paged", CHUNK, "f32"), ("contiguous", 1, "f32"),
                         ("paged", CHUNK, "int8")),
         "mixtral-8x7b": (("paged", CHUNK, "f32"), ("paged", CHUNK, "int8"))}


def per_step(cfg):
    """Kernel launches of one prefill or decode step (and of one forward),
    from the config, and the number of attention blocks: each attention
    block runs 4 projections (q, k, v, o), a norm, 3 bias adds when the
    arch has qkv biases, and its layout's attention kernel; each MLP
    (one per attention block but in moe) 3 projections and a norm; each
    MoE block (one per moe layer) a norm, its router and expert products
    running outside the kernels as in JAX; each Mamba block 2 projections
    (in, out), 2 norms (ln, ln_inner) and one SSD scan; the head one
    projection and the final norm one norm.  Dense runs an attention block
    and an MLP per layer, moe an attention block and a MoE block per
    layer, ssm a Mamba block per layer, hybrid a Mamba block per layer and
    the shared attention block and MLP once per group of ``attn_every``
    layers."""
    n_attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}[cfg.family]
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_mlp = 0 if cfg.family == "moe" else n_attn
    n_moe = n_attn - n_mlp
    return {"gemm": 4 * n_attn + 3 * n_mlp + 2 * n_mamba + 1,
            "rmsnorm": n_attn + n_mlp + n_moe + 2 * n_mamba + 1,
            "bias_add_rows": 3 * n_attn if cfg.qkv_bias else 0,
            "ssd_scan": n_mamba}, n_attn


def kernel_fns():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.conv_direct import conv2d_direct
    from repro_torch.kernels.eltwise import bias_add_rows, relu, relu_bwd
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.im2col import col2im, im2col
    from repro_torch.kernels.mamba_scan import ssd_scan
    from repro_torch.kernels.pooling import maxpool, maxpool_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.softmax_xent import (softmax, softmax_xent,
                                                  softmax_xent_bwd)
    fns = {"gemm": gemm, "rmsnorm": rmsnorm, "bias_add_rows": bias_add_rows,
           "ssd_scan": ssd_scan, "rmsnorm_bwd": rmsnorm_bwd,
           "im2col": im2col, "maxpool": maxpool, "relu": relu,
           "softmax": softmax, "softmax_xent": softmax_xent,
           "col2im": col2im, "maxpool_bwd": maxpool_bwd,
           "relu_bwd": relu_bwd, "softmax_xent_bwd": softmax_xent_bwd,
           "conv2d_direct": conv2d_direct}
    fns.update({name: getattr(FA, name) for name in KERNELS
                if name.startswith("flash_")})
    return fns


# the decodes on the split route in bf16, on the template in f32
DECODES = ("flash_decode", "flash_decode_paged", "flash_decode_paged_quant")
# the kernels with several routes (``fn.routes``: launches per route,
# beside ``fn.launches``), each route's source, and the launches per route
# summed over every counted run of a main path (phases 4-10)
# the chunked prefills: bf16 on the tensor-core chunk kernel, f32 on the
# template
CHUNKS = ("flash_prefill_chunk", "flash_prefill_chunk_paged",
          "flash_prefill_chunk_paged_quant")
ROUTED = ("gemm", "flash_attention_bwd", "flash_attention") + DECODES \
    + CHUNKS + ("rmsnorm_bwd", "conv2d_direct", "relu_bwd", "maxpool",
                "relu", "ssd_scan", "softmax", "rmsnorm", "bias_add_rows",
                "im2col", "col2im", "softmax_xent", "maxpool_bwd",
                "softmax_xent_bwd")
ROUTE_SOURCES = {
    ("gemm", "skinny"): "src/repro_torch/kernels/csrc/gemm.cu",
    ("gemm", "tiled"): "src/repro_torch/kernels/csrc/gemm.cu",
    ("gemm", "tc"): "src/repro_torch/kernels/csrc/gemm_tc.cu",
    ("gemm", "tc_splitk"): "src/repro_torch/kernels/csrc/gemm_tc.cu",
    ("gemm", "f32_small"): "src/repro_torch/kernels/csrc/gemm_f32.cu",
    ("gemm", "f32_splitk"): "src/repro_torch/kernels/csrc/gemm_f32.cu",
    ("flash_attention_bwd", "tc"):
        "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
    ("flash_attention_bwd", "scalar"):
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    ("flash_attention", "tc"):
        "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
    ("flash_attention", "scalar"):
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    ("rmsnorm_bwd", "vec"): "src/repro_torch/kernels/csrc/rmsnorm.cu",
    ("rmsnorm_bwd", "scalar"): "src/repro_torch/kernels/csrc/rmsnorm.cu",
    ("conv2d_direct", "reg"): "src/repro_torch/kernels/csrc/conv_direct.cu",
    ("conv2d_direct", "scalar"):
        "src/repro_torch/kernels/csrc/conv_direct.cu",
    ("relu_bwd", "vec"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("relu_bwd", "strided"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("maxpool", "plane"): "src/repro_torch/kernels/csrc/pooling.cu",
    ("maxpool", "strided"): "src/repro_torch/kernels/csrc/pooling.cu",
    ("relu", "vec"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("relu", "scalar"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("ssd_scan", "step"): "src/repro_torch/kernels/csrc/ssd_scan.cu",
    ("ssd_scan", "split"): "src/repro_torch/kernels/csrc/ssd_scan.cu",
    ("ssd_scan", "block"): "src/repro_torch/kernels/csrc/ssd_scan.cu",
    ("softmax", "rows"): "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("softmax", "strided"): "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("rmsnorm", "vec"): "src/repro_torch/kernels/csrc/rmsnorm.cu",
    ("rmsnorm", "scalar"): "src/repro_torch/kernels/csrc/rmsnorm.cu",
    ("bias_add_rows", "vec"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("bias_add_rows", "scalar"): "src/repro_torch/kernels/csrc/eltwise.cu",
    ("im2col", "band"): "src/repro_torch/kernels/csrc/im2col.cu",
    ("im2col", "flat"): "src/repro_torch/kernels/csrc/im2col.cu",
    ("col2im", "tile"): "src/repro_torch/kernels/csrc/im2col.cu",
    ("col2im", "flat"): "src/repro_torch/kernels/csrc/im2col.cu",
    ("softmax_xent", "rows"):
        "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("softmax_xent", "strided"):
        "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("softmax_xent_bwd", "rows"):
        "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("softmax_xent_bwd", "strided"):
        "src/repro_torch/kernels/csrc/softmax_xent.cu",
    ("maxpool_bwd", "window"): "src/repro_torch/kernels/csrc/pooling.cu",
    ("maxpool_bwd", "pixel"): "src/repro_torch/kernels/csrc/pooling.cu",
}
ROUTE_SOURCES.update({
    (name, route): f"src/repro_torch/kernels/csrc/{src}"
    for name in DECODES
    for route, src in (("split", "flash_decode_split.cu"),
                       ("template", "flash_attention.cu"))})
ROUTE_SOURCES.update({
    (name, route): f"src/repro_torch/kernels/csrc/{src}"
    for name in CHUNKS
    for route, src in (("tc", "flash_chunk_tc.cu"),
                       ("template", "flash_attention.cu"))})
MAIN_ROUTES = {}


def zero_counts(fns):
    """Every kernel's launch count, and each route's, set to 0."""
    for fn in fns.values():
        fn.launches = 0
        for r in getattr(fn, "routes", {}):
            fn.routes[r] = 0


def read_counts(fns, lm=True):
    """The launches of each kernel since ``zero_counts``; the routed
    kernels' launches per route are added to ``MAIN_ROUTES``.  On an LM
    path (``lm``) every RMSNorm and bias launch must have taken "vec"
    (the Caffe paths' bias routes are held by ``caffe_counted``)."""
    if lm:
        for name in ("rmsnorm", "bias_add_rows"):
            want_route(name, "+".join(r for r, n in fns[name].routes.items()
                                      if n) or "vec", "vec")
    for name in ROUTED:
        tot = MAIN_ROUTES.setdefault(name, dict.fromkeys(fns[name].routes, 0))
        for r, n in fns[name].routes.items():
            tot[r] += n
    return {name: fn.launches for name, fn in fns.items()}


def ssd_routes(cfg, steps, chunked, forwards=0):
    """``ssd_scan``'s launches per route over ``steps`` single-token steps
    (decode: "step"), ``chunked`` chunk steps and ``forwards`` whole-
    sequence forwards ("split"), one a Mamba layer each; none on
    "block"."""
    n = per_step(cfg)[0]["ssd_scan"]
    return {"step": n * steps, "split": n * (chunked + forwards),
            "block": 0}


def serve_path(torch, model, params, reqs, layout, chunk, kv_dtype):
    """Serve ``reqs`` on the hopper backend with the launch counts set to
    0 just before and read just after; the prefill and decode loops may
    not synchronise with the host.  Returns (launches, outputs, stats)."""
    from repro_torch.core.policy import use_backend
    from repro_torch.serving import CacheConfig, EngineConfig, ServingEngine

    eng = ServingEngine(model, params, batch=B, max_len=MAX_LEN,
                        cache=CacheConfig(layout=layout, page_size=PAGE,
                                          kv_dtype=kv_dtype),
                        config=EngineConfig(steps_per_sync=8,
                                            prefill_chunk=chunk))
    for toks in reqs:
        eng.submit(toks, GEN_LEN)
    fns = kernel_fns()
    pool = f", {kv_dtype} pool" if kv_dtype != "f32" else ""
    tag = (f"[4 serving] {model.cfg.name}, {layout}{pool}, prefill chunk "
           f"{chunk}:")
    with use_backend("hopper"):
        zero_counts(fns)
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
        launches = read_counts(fns)
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
    print(f"{tag} launches {launches}; rmsnorm routes "
          f"{fns['rmsnorm'].routes}, bias_add_rows routes "
          f"{fns['bias_add_rows'].routes}", flush=True)
    # every bf16 decode launch (slab, bf16 pool, int8 pool) on the split
    # kernel
    for name in DECODES:
        rt, n = dict(fns[name].routes), launches[name]
        want_rt = ({"split": n, "template": 0}
                   if model.cfg.dtype == "bfloat16"
                   else {"split": 0, "template": n})
        if n:
            print(f"{tag} {name} routes {rt}", flush=True)
        if rt != want_rt:
            raise SystemExit(f"chip_smoke: {tag} {name} routes {rt}, "
                             f"expected {want_rt}")
    # every bf16 chunk (the slab, a bf16 or an int8 pool) on the
    # tensor-core chunk kernel
    for name in CHUNKS:
        rt, n = dict(fns[name].routes), launches[name]
        tc = model.cfg.dtype == "bfloat16"
        want_rt = {"tc": n if tc else 0, "template": 0 if tc else n}
        if n:
            print(f"{tag} {name} routes {rt}", flush=True)
        if rt != want_rt:
            raise SystemExit(f"chip_smoke: {tag} {name} routes {rt}, "
                             f"expected {want_rt}")
    steps, n_attn = per_step(model.cfg)
    # every decode scan on "step", every chunk's on "split"
    rt, want_rt = dict(fns["ssd_scan"].routes), ssd_routes(model.cfg, dec,
                                                           pre)
    if launches["ssd_scan"]:
        print(f"{tag} ssd_scan routes {rt}", flush=True)
    if rt != want_rt:
        raise SystemExit(f"chip_smoke: {tag} ssd_scan routes {rt}, "
                         f"expected {want_rt}")
    want = {name: 0 for name in KERNELS}
    want.update({name: n * (pre + dec) for name, n in steps.items()})
    k_dec, k_pre = ATTN[layout, kv_dtype]
    want[k_dec] += n_attn * dec
    want[k_pre] += n_attn * pre
    if launches != want or (chunk > 1) != (pre > 0):
        raise SystemExit(f"chip_smoke: {tag} launches "
                         f"{launches}, expected {want} for {pre} prefill + "
                         f"{dec} decode steps")
    outs = eng.outputs
    if sorted(outs) != list(range(len(reqs))) or any(
            len(o) != GEN_LEN or o.min() < 0 or o.max() >= model.cfg.vocab_size
            for o in outs.values()):
        raise SystemExit(f"chip_smoke: {tag} serving outputs malformed")
    return launches, outs, s


def first_logits(torch, model, params, toks, layout, backend):
    """The first steps' logits on ``backend``: one 16-token prefill chunk
    then 4 decode steps (``layout="paged"``; for mamba2 the chunk route
    without pages), or 6 decode steps (contiguous)."""
    from repro_torch.core.policy import use_backend

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
    return torch.stack(steps_l)


def compare(got, want):
    """(max |got - want|, max |want|, top-1 agreement)."""
    return ((got - want).abs().max().item(), want.abs().max().item(),
            (got.argmax(-1) == want.argmax(-1)).float().mean().item())


def to_f32(tree):
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


class LazyF32:
    """A list of bf16 layers that yields each one cast to f32 only while
    the model's layer loop runs it, so an f32 run of a model whose f32
    weights do not fit the card holds one f32 layer at a time."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        return (to_f32(p) for p in self.layers)

    def __len__(self):
        return len(self.layers)


# the depth at which the Mamba stacks' logits are held (two zamba2 groups)
GATE_LAYERS = 12


def check_logits(torch, model, params, reqs, layout):
    """The first steps' logits, hopper vs reference, same inputs.  qwen2.5-3b
    is held in bf16 within 5% of the scale: the two sides round at
    different places (the attention kernels' p, rmsnorm's rsqrt).  The
    random 64- and 54-layer Mamba stacks are chaotic: the reference alone,
    in bf16 and in f32 on the same bf16-valued weights, disagrees on
    nearly every top-1 token at full depth (PERF.md, section 6).  So
    mamba2 and zamba2 print their full-depth bf16 numbers and are held in
    f32 at full width and ``GATE_LAYERS`` layers (their first layers'
    weights), within 1% of the scale.  mixtral's top-2 router flips at a
    near tie when the two sides round differently, and the reference's own
    bf16 run is as far from its f32 run on the same weights as the hopper
    run is from the reference (PERF.md, section 6): its bf16 numbers are
    printed beside that gap, and it is held in f32 at its 16 layers within
    1% (each layer cast while it runs); phase 3 holds its kernels at its
    shapes in bf16."""
    from repro_torch.models.model import build_model

    cfg = model.cfg
    tag = f"[4 serving] {cfg.name}, {layout}:"
    toks = torch.as_tensor(
        np.stack([np.resize(r, CHUNK + 4) for r in reqs[:B]]), device="cuda")
    hop, refl = (first_logits(torch, model, params, toks, layout, b)
                 for b in ("hopper", "reference"))
    err, scale, agree = compare(hop, refl)
    print(f"{tag} first {hop.shape[0]} steps' bf16 logits vs reference: "
          f"max_abs_err {err:.4g} (max|logit| {scale:.4g}), top-1 "
          f"agreement {agree:.3f}", flush=True)
    tol = 0.05
    if cfg.family == "moe":
        p32 = {**to_f32({k: v for k, v in params.items() if k != "layers"}),
               "layers": LazyF32(params["layers"])}
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        ref32 = first_logits(torch, m32, p32, toks, layout, "reference")
        own, own_scale, own_agree = compare(refl, ref32)
        hop_f, _, hop_agree = compare(hop, ref32)
        print(f"{tag} vs the reference in f32 (same bf16 weights): the "
              f"reference's own bf16 logits max_abs_err {own:.4g} (max|logit|"
              f" {own_scale:.4g}), top-1 agreement {own_agree:.3f}; hopper's "
              f"bf16 logits {hop_f:.4g}, top-1 agreement {hop_agree:.3f} "
              "(printed; held in f32 below)", flush=True)
        if not torch.isfinite(hop).all():
            raise SystemExit(f"chip_smoke: {cfg.name}, {layout}: bf16 "
                             "logits not finite")
        err, scale, agree = compare(
            first_logits(torch, m32, p32, toks, layout, "hopper"), ref32)
        print(f"{tag} f32 at {cfg.n_layers} layers, hopper vs reference: "
              f"max_abs_err {err:.4g} (max|logit| {scale:.4g}), top-1 "
              f"agreement {agree:.3f}", flush=True)
        tol = 0.01
        del p32, ref32
    elif cfg.family != "dense":
        if "groups" in params:
            cut = {**params, "groups": params["groups"][:GATE_LAYERS
                                                        // cfg.attn_every]}
        else:
            cut = {**params, "layers": params["layers"][:GATE_LAYERS]}
        p32 = to_f32(cut)
        m32 = build_model(dataclasses.replace(cfg, n_layers=GATE_LAYERS,
                                              dtype="float32"))
        err, scale, agree = compare(*(
            first_logits(torch, m32, p32, toks, layout, b)
            for b in ("hopper", "reference")))
        print(f"{tag} f32 at {GATE_LAYERS} layers, hopper vs reference: "
              f"max_abs_err {err:.4g} (max|logit| {scale:.4g}), top-1 "
              f"agreement {agree:.3f}", flush=True)
        tol = 0.01
        del p32
    if not (np.isfinite(err) and err <= tol * scale):
        raise SystemExit(f"chip_smoke: {cfg.name}, {layout}: logits differ "
                         f"by {err:.4g} (max|logit| {scale:.4g})")


def phase_serving(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import build_model

    total = {name: 0 for name in KERNELS}
    for arch, paths in PATHS.items():
        cfg = get_arch(arch)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_params(SEED)
        perturb(torch, params, SEED + 1)
        torch.cuda.synchronize()
        print(f"[4 serving] {cfg.name}: {cfg.family}, {cfg.n_layers} "
              f"layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype}; params in {time.perf_counter() - t0:.1f} s",
              flush=True)
        reqs = requests(8, 16, 64, cfg.vocab_size, SEED)
        streams, stats = {}, {}
        for path in paths:
            launches, streams[path], stats[path] = serve_path(
                torch, model, params, reqs, *path)
            for name in KERNELS:
                total[name] += launches[name]
        p0, p1 = paths[:2]
        same = sum(np.array_equal(streams[p0][i], streams[p1][i])
                   for i in range(len(reqs)))
        print(f"[4 serving] {cfg.name}: bf16 streams, {p0} vs {p1}: {same} "
              f"of {len(reqs)} identical (bf16 and int8 round differently "
              "per schedule and pool; phase 5 holds f32)", flush=True)
        # the int8 pool holds the same pages at half the bf16 pool's bytes
        s16, s8 = stats.get(("paged", CHUNK, "f32")), stats.get(
            ("paged", CHUNK, "int8"))
        if s8 is not None:
            b16, b8 = s16["kv_resident_bytes_peak"], \
                s8["kv_resident_bytes_peak"]
            print(f"[4 serving] {cfg.name}: peak resident KV, paged chunk "
                  f"{CHUNK}: bf16 pool {int(b16)} bytes at "
                  f"{int(s16['kv_pages_peak'])} pages, int8 pool {int(b8)} "
                  f"bytes at {int(s8['kv_pages_peak'])} pages", flush=True)
            if not (s8["kv_pages_peak"] == s16["kv_pages_peak"]
                    and 2 * b8 == b16 > 0):
                raise SystemExit(f"chip_smoke: {cfg.name}: the int8 pool's "
                                 f"{b8} bytes are not half the bf16 pool's "
                                 f"{b16} at the same peak pages")
        # the chunk route (paged, for the archs with KV) and token by token
        for layout in ("paged", "contiguous"):
            check_logits(torch, model, params, reqs, layout)
        del params, model
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 5: f32, IEEE on both sides: identical token streams
# ---------------------------------------------------------------------------

# (arch, layers, ((layout, kv_dtype, prefill chunks), ...)): reduced
# depth, full width; zamba2 needs 12 layers to keep attn_every = 6 with 2
# groups; mixtral's window refuses contiguous chunks
BOTH = (1, CHUNK)
F32_CASES = (
    ("qwen2.5-3b", 2, (("contiguous", "f32", BOTH), ("paged", "f32", BOTH),
                       ("paged", "bf16", BOTH), ("paged", "int8", BOTH))),
    ("mamba2-2.7b", 2, (("contiguous", "f32", BOTH),)),
    ("zamba2-2.7b", 12, (("contiguous", "f32", BOTH), ("paged", "f32", BOTH),
                         ("paged", "bf16", BOTH), ("paged", "int8", BOTH))),
    ("mixtral-8x7b", 2, (("contiguous", "f32", (1,)), ("paged", "f32", BOTH),
                         ("paged", "bf16", BOTH), ("paged", "int8", BOTH))))


def synced_steps(torch, model, params, reqs, kv_dtype, chunk):
    """Hopper against reference one step at a time from the same state:
    before each step the reference gets a copy of the hopper side's
    caches, so only that step's arithmetic differs.  The first 8 tokens
    of each of the first B requests go in as one 8-token chunk (``chunk >
    1``) or 8 decode steps, then 8 decode steps feed the hopper side's
    argmax.  Returns (max |logit diff| / max |logit| over the steps, max
    difference of the first layer's bf16 pages in bf16 ulps: 2^-7 of the
    larger value but at least 1e-5 of the pool's largest value, the f32
    noise of two summation orders on values near zero).  Only the first
    layer's K/V come from identical inputs: a new element one ulp apart
    there moves the next layer's input, and so its K/V, by more than an
    ulp within the same call."""
    from repro_torch.core.policy import use_backend

    state = model.init_decode_state(B, 64, per_row_pos=True, layout="paged",
                                    page_size=PAGE, kv_dtype=kv_dtype)
    toks = torch.as_tensor(np.stack([np.asarray(r[:8]) for r in reqs[:B]]),
                           device="cuda")
    if chunk > 1:
        feeds = [lambda m, p, s: m.prefill_chunk(p, s, toks, 8)]
    else:
        feeds = [lambda m, p, s, j=j: m.decode_step(p, s, toks[:, j])
                 for j in range(8)]
    worst_rel = worst_pool = 0.0
    nxt = None
    for n in range(len(feeds) + 8):
        ref_state = {k: v.clone() for k, v in state.items()}
        fn = feeds[n] if n < len(feeds) else (
            lambda m, p, s, t=nxt: m.decode_step(p, s, t))
        with use_backend("hopper"):
            lh, state = fn(model, params, state)
        with use_backend("reference"):
            lr, ref_state = fn(model, params, ref_state)
        worst_rel = max(worst_rel, ((lh - lr).abs().max()
                                    / lr.abs().max()).item())
        for key in ("kp", "vp"):   # layer 0's real pages, not the sentinel
            a, b = state[key][0, :-1].float(), ref_state[key][0, :-1].float()
            step = torch.clamp(2 ** -7 * torch.maximum(a.abs(), b.abs()),
                               min=1e-5 * b.abs().max().item())
            worst_pool = max(worst_pool, ((a - b).abs() / step).max().item())
        nxt = lh.argmax(-1)
    return worst_rel, worst_pool


class Decisions:
    """While active, records the router probabilities of every MoE call
    (the input of ``components._top_k``) and the logits of every engine
    step (the input of ``engine._sample``), so that two runs can be
    searched for the first decision they take differently."""

    def __init__(self):
        from repro_torch.models import components
        from repro_torch.serving import engine
        self.hooks = ((components, "_top_k"), (engine, "_sample"))
        self.probs, self.logits = [], []

    def __enter__(self):
        top_k, sample = self.saved = [getattr(m, n) for m, n in self.hooks]

        def traced_top_k(probs, k):
            self.probs.append(probs.detach().clone())
            return top_k(probs, k)

        def traced_sample(logits):
            self.logits.append(logits.detach().float().clone())
            return sample(logits)

        for (m, n), fn in zip(self.hooks, (traced_top_k, traced_sample)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.hooks, self.saved):
            setattr(m, n, fn)


def first_split(torch, hop, refd, k, n_layers,
                names=("hopper", "reference")):
    """The first decision two runs of one schedule (``Decisions`` of the
    runs ``names``, by default the hopper and the reference run) take
    differently: a token's top-k expert picks, or a row's argmax.
    Returns (description, the second run's margin at it relative to the
    value it separates); when they never split, (how closely they agree,
    None)."""
    a_, b_ = names
    gap_p = gap_l = 0.0
    for step, (lh, lr) in enumerate(zip(hop.logits, refd.logits)):
        lh, lr = lh.cpu(), lr.cpu()
        for layer in range(n_layers):
            ph, pr = (d.probs[step * n_layers + layer].cpu()
                      for d in (hop, refd))
            pick_h, pick_r = (torch.sort(-p, dim=-1, stable=True)
                              .indices[:, :k].sort(dim=-1).values
                              for p in (ph, pr))
            rows = (pick_h != pick_r).any(-1).nonzero()
            if len(rows):
                r0 = int(rows[0])
                top_r = torch.sort(pr[r0], descending=True).values[:k + 1]
                top_h = torch.sort(ph[r0], descending=True).values[:k + 1]
                margin = (top_r[k - 1] - top_r[k]).item()
                return (f"step {step}, layer {layer}, token {r0} of "
                        f"{pr.shape[0]}: router picks differ; {b_}'s "
                        f"top-{k + 1} probabilities {top_r.tolist()}, "
                        f"{a_}'s {top_h.tolist()}: margin {margin:.3g} "
                        f"between pick {k} and {k + 1}; before it the "
                        f"probabilities agreed within {gap_p:.3g} and the "
                        f"logits within {gap_l:.3g}",
                        margin / top_r[k - 1].item())
            gap_p = max(gap_p, (ph - pr).abs().max().item())
        rows = (lh.argmax(-1) != lr.argmax(-1)).nonzero()
        if len(rows):
            r0 = int(rows[0])
            top2 = torch.topk(lr[r0], 2).values
            margin = (top2[0] - top2[1]).item()
            scale = lr[r0].abs().max().item()
            return (f"step {step}, row {r0}: argmax differs; {b_}'s "
                    f"top-2 logits {top2.tolist()}: margin {margin:.3g} "
                    f"(max|logit| {scale:.4g}); before it the router "
                    f"probabilities agreed within {gap_p:.3g} and the logits "
                    f"within {gap_l:.3g}", margin / scale)
        gap_l = max(gap_l, (lh - lr).abs().max().item())
    return (f"none in {len(refd.logits)} steps; the router probabilities "
            f"agree within {gap_p:.3g} and the logits within {gap_l:.3g}",
            None)


# (arch, kv_dtype, prefill chunk) whose f32 streams may split at a near
# tie: mixtral over a bf16 pool token by token.  A last-bit difference in
# a new K/V element can round to the neighbouring bf16 value (2^-8 of it),
# and a top-2 router or an argmax closer than that turns it into another
# token.  The split must be such a tie (the reference's margin at the
# first differing decision within 2^-8 of the value), and each step from
# the same caches must agree (``synced_steps``).  As a witness, the same
# engine on the reference backend also runs on the CPU (same code and
# semantics, other f32 arithmetic) and its streams are compared with both
# card runs.
NEAR_TIE = {("mixtral-8x7b", "bf16", 1)}


def cpu_witness(torch, model, params, engine_kw, reqs, card):
    """The reference engine of ``engine_kw`` on the CPU, its streams and
    decisions compared with the card runs' (``card``: backend ->
    (streams, Decisions)); prints, gates nothing."""
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    t0 = time.perf_counter()
    cpu_model = build_model(model.cfg, device="cpu")
    with use_backend("reference"), Decisions() as trace:
        eng = ServingEngine(cpu_model, to_cpu(params), **engine_kw)
        for toks in reqs:
            eng.submit(toks, 16)
        got = eng.run()
    for backend, (streams, dec) in card.items():
        same = sum(np.array_equal(got[i], streams[i])
                   for i in range(len(reqs)))
        split = first_split(torch, trace, dec, model.cfg.top_k,
                            model.cfg.n_layers,
                            names=("CPU reference", f"card {backend}"))
        print(f"[5 f32] witness: the reference engine on the CPU vs the "
              f"{backend} run on the card: {same} of {len(reqs)} streams "
              f"identical; first split: {split[0]}", flush=True)
    print(f"[5 f32] witness took {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_f32(torch):
    """Every case runs; the phase fails after the last one if any pair of
    streams differed (with the first differing request and position),
    except a case of ``NEAR_TIE`` whose split is shown to be a near tie.
    Where both chunks ran, the two runs of each backend are compared too
    (printed): the chunk changes the summation order, over an int8 pool
    the requantization sequence, and for moe the capacity, which counts
    the B*C tokens of a chunk step.  The hopper runs' launches are counted
    (each run from 0) and returned; their decodes, f32 queries over every
    cache and pool, must stay on the template."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving import CacheConfig, EngineConfig, ServingEngine

    failed = []
    total = {name: 0 for name in KERNELS}
    for arch, layers, cases in F32_CASES:
        model = build_model(dataclasses.replace(
            get_arch(arch), n_layers=layers, dtype="float32"))
        cfg = model.cfg
        params = model.init_params(SEED)
        perturb(torch, params, SEED + 1)
        reqs = requests(6, 8, 24, cfg.vocab_size, SEED + 2)
        for layout, kv_dtype, chunks in cases:
            pool = f", {kv_dtype} pool" if kv_dtype != "f32" else ""
            streams = {}
            for chunk in chunks:
                trace = {}
                engine_kw = dict(
                    batch=B, max_len=64,
                    cache=CacheConfig(layout=layout, page_size=PAGE,
                                      kv_dtype=kv_dtype),
                    config=EngineConfig(steps_per_sync=4,
                                        prefill_chunk=chunk))
                for backend in ("hopper", "reference"):
                    got, rt = {}, {}
                    with use_backend(backend), Decisions() as trace[backend]:
                        eng = ServingEngine(model, params, **engine_kw)
                        for toks in reqs:
                            eng.submit(toks, 16)
                        if backend == "hopper":
                            with counting(got, rt):
                                streams[backend, chunk] = eng.run()
                            want_rt = ssd_routes(cfg, eng.steps,
                                                 eng.prefill_steps)
                            if rt["ssd_scan"] != want_rt:
                                failed.append((arch, layout, kv_dtype, chunk,
                                               f"ssd_scan routes "
                                               f"{rt['ssd_scan']}, expected "
                                               f"{want_rt}"))
                        else:
                            streams[backend, chunk] = eng.run()
                    for name, n in got.items():
                        total[name] += n
                    # f32 queries, over any cache or pool, stay on the
                    # template
                    for name in DECODES + CHUNKS:
                        dec = rt.get(name, {})
                        if dec.get("split") or dec.get("tc"):
                            failed.append((arch, layout, kv_dtype, chunk,
                                           f"{name} routes {dec}"))
                        if dec.get("template"):
                            print(f"[5 f32] {arch}, {layout}{pool}, prefill "
                                  f"chunk {chunk}: {name} routes {dec}",
                                  flush=True)
                got, want = streams["hopper", chunk], \
                    streams["reference", chunk]
                diff = [(i, int(np.argmax(got[i] != want[i])))
                        for i in range(len(reqs))
                        if not np.array_equal(got[i], want[i])]
                print(f"[5 f32] {arch}, {layers} layers at full width, "
                      f"{layout}{pool}, prefill chunk {chunk}, {len(reqs)} "
                      f"requests x 16 tokens: hopper == reference token "
                      f"streams: {not diff}"
                      + (f" (first differing (request, token): {diff})"
                         if diff else ""), flush=True)
                if not diff:
                    continue
                split = (first_split(torch, trace["hopper"],
                                     trace["reference"], cfg.top_k,
                                     cfg.n_layers)
                         if cfg.family == "moe" else None)
                if split is not None:
                    print(f"[5 f32] {arch}{pool}, chunk {chunk}: first "
                          f"split: {split[0]}", flush=True)
                    split = split[1]
                if (arch, kv_dtype, chunk) not in NEAR_TIE:
                    failed.append((arch, layout, kv_dtype, chunk))
                    continue
                rel, pool_steps = synced_steps(torch, model, params, reqs,
                                               kv_dtype, chunk)
                print(f"[5 f32] {arch}{pool}, chunk {chunk}, step by step "
                      f"from the same caches: logits within {rel:.3g} of "
                      f"their scale, pools within {pool_steps:.3g} storage "
                      f"steps", flush=True)
                cpu_witness(torch, model, params, engine_kw, reqs, {
                    b: (streams[b, chunk], trace[b])
                    for b in ("reference", "hopper")})
                if not (split is not None and split <= 2 ** -8
                        and rel <= 0.01 and pool_steps <= 1.0):
                    failed.append((arch, layout, kv_dtype, chunk))
            if len(chunks) > 1:
                same = {b: sum(np.array_equal(streams[b, 1][i],
                                              streams[b, chunks[-1]][i])
                               for i in range(len(reqs)))
                        for b in ("hopper", "reference")}
                print(f"[5 f32] {arch}, {layout}{pool}: chunk 1 vs "
                      f"{chunks[-1]} on one backend: reference "
                      f"{same['reference']} of {len(reqs)} streams "
                      f"identical, hopper {same['hopper']}", flush=True)
        del params, model
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: f32 token streams differ: {failed}")
    return total


# ---------------------------------------------------------------------------
# phase 6: the serving CLI's --check, decode vs the teacher-forced forward
# ---------------------------------------------------------------------------

CHECK_LEN, CHECK_B = 160, 2
# (arch, ((layers, dtype), ...)): f32 at the phase-5 depth; then qwen2.5-3b
# in bf16 at full depth, and mamba2 in f32 at ``GATE_LAYERS``: the random
# Mamba stacks are chaotic at full depth (``check_logits``)
CHECK_CASES = (("qwen2.5-3b", ((2, "float32"), (36, "bfloat16"))),
               ("mamba2-2.7b", ((2, "float32"), (GATE_LAYERS, "float32"))),
               ("zamba2-2.7b", ((GATE_LAYERS, "float32"),)),
               ("mixtral-8x7b", ((2, "float32"),)))


def phase_check(torch):
    """For each arch at full width and the depths of ``CHECK_CASES`` (f32
    within JAX's 2e-2 for all four; bf16 within 5% of the logits' scale
    for qwen2.5-3b only, at full depth): ``--check``'s helper
    on the hopper backend with the launch counts set to 0 just before and
    read just after.  The moe arch's capacity_factor is lifted to its
    expert count, as ``launch/serve.py --check`` lifts it: the forward
    routes B*S tokens at once and decode B, so with capacity dropping the
    two would drop different tokens.  One forward runs every kernel of a
    step once per block (plus the head), and the attention forward once
    per attention block; the 160 decode steps run the step's kernels and
    the contiguous decode attention."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.models.model import build_model
    from repro_torch.serving.checks import (
        assert_decode_matches_teacher_forced,
    )

    fns = kernel_fns()
    total = {name: 0 for name in KERNELS}
    for arch, cases in CHECK_CASES:
        for layers, dtype in cases:
            f32 = dtype == "float32"
            cfg = get_arch(arch)
            lift = ({"capacity_factor": float(cfg.n_experts)}
                    if cfg.n_experts else {})
            model = build_model(dataclasses.replace(
                cfg, n_layers=layers, dtype=dtype, **lift))
            cfg = model.cfg
            params = model.init_params(SEED + 3)
            perturb(torch, params, SEED + 4)
            prompt = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
                0, cfg.vocab_size, (CHECK_B, CHECK_LEN)), device="cuda")
            with use_backend("hopper"):
                zero_counts(fns)
                t0 = time.perf_counter()
                try:
                    err, scale = assert_decode_matches_teacher_forced(
                        model, params, prompt, CHECK_LEN + 32,
                        scale_tol=None if f32 else 0.05)
                except AssertionError as e:
                    raise SystemExit(f"chip_smoke: --check {cfg.name} "
                                     f"({cfg.dtype}): {e}")
                secs = time.perf_counter() - t0
                launches = read_counts(fns)
                fwd_routes = dict(fns["flash_attention"].routes)
                dec_routes = dict(fns["flash_decode"].routes)
                ssd_rt = dict(fns["ssd_scan"].routes)
            steps, n_attn = per_step(cfg)
            # the teacher-forced forward's attention: bf16 on the
            # tensor-core kernel, f32 on the template; the decode's: bf16
            # on the split kernel, f32 on the template
            want_fwd = {"tc": 0 if f32 else n_attn,
                        "scalar": n_attn if f32 else 0}
            n_dec = n_attn * CHECK_LEN
            want_dec = {"split": 0 if f32 else n_dec,
                        "template": n_dec if f32 else 0}
            # the teacher-forced forward's scans on "split", the decode's
            # on "step"
            want_ssd = ssd_routes(cfg, CHECK_LEN, 0, forwards=1)
            if fwd_routes != want_fwd or dec_routes != want_dec \
                    or ssd_rt != want_ssd:
                raise SystemExit(f"chip_smoke: --check {cfg.name}: "
                                 f"flash_attention routes {fwd_routes}, "
                                 f"expected {want_fwd}; flash_decode "
                                 f"routes {dec_routes}, expected "
                                 f"{want_dec}; ssd_scan routes {ssd_rt}, "
                                 f"expected {want_ssd}")
            want = {name: 0 for name in KERNELS}
            want.update({name: n * (CHECK_LEN + 1)
                         for name, n in steps.items()})
            want["flash_attention"] = n_attn
            want["flash_decode"] = n_dec
            tol = "2e-2" if f32 else f"5% of {scale:.4g}"
            print(f"[6 check] {cfg.name} {cfg.n_layers} layers {cfg.dtype}:"
                  f" decode of {CHECK_B}x{CHECK_LEN} tokens vs teacher-forced"
                  f" forward: max |diff| {err:.4g} (max |logit| "
                  f"{scale:.4g}, allowed {tol}) in {secs:.1f} s; launches "
                  f"{launches}; flash_attention routes {fwd_routes}; "
                  f"flash_decode routes {dec_routes}"
                  + (f"; ssd_scan routes {ssd_rt}" if launches["ssd_scan"]
                     else ""), flush=True)
            if launches != want:
                raise SystemExit(f"chip_smoke: --check {cfg.name}: launches "
                                 f"{launches}, expected {want}")
            for name in KERNELS:
                total[name] += launches[name]
            del params, model
            torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 7: training through make_train_step and launch/train.py's loop
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
# (a) bf16 at full depth, hopper vs reference: each grad leaf within 5% in
# relative L2 (both round to bf16 at different places: the kernels keep
# the backward's sums in f32 and round attention's p and ds to bf16 only
# as tensor-core operands, the plain versions' autograd rounds them to
# bf16 throughout), the loss within 1%
BF16_GRAD_TOL, BF16_LOSS_TOL = 0.05, 0.01
# (c) f32 at 2 layers: each grad leaf within 1e-4 of its largest value
# (summation order), the loss within 1e-5; params, master and moments as
# ``close_state`` says
F32_GRAD_TOL, F32_LOSS_TOL = 1e-4, 1e-5


def train_per_step(cfg):
    """Kernel launches of one loss-and-grad (the optimizer update runs no
    kernel): every layer's forward runs twice (in the step, and again when
    the backward rematerializes it), each projection's backward is two
    gemms (g @ W^T, x^T @ g), each norm's one rmsnorm_bwd and each
    attention's one flash_attention_bwd; the bias add's and the SSD scan's
    backward are plain PyTorch; the head and the final norm run once
    forward and once backward.  Dense, moe and ssm: hybrid also
    rematerializes its groups, which runs its Mamba layers three times."""
    if cfg.family == "hybrid":
        raise ValueError("train_per_step: dense, moe and ssm only")
    steps, n_attn = per_step(cfg)
    lg, ln = steps["gemm"] - 1, steps["rmsnorm"] - 1   # the layers' own
    want = {name: 0 for name in KERNELS}
    want.update(gemm=4 * lg + 3, rmsnorm=2 * ln + 1, rmsnorm_bwd=ln + 1,
                bias_add_rows=2 * steps["bias_add_rows"],
                ssd_scan=2 * steps["ssd_scan"], flash_attention=2 * n_attn,
                flash_attention_bwd=n_attn)
    return want


@contextlib.contextmanager
def counting(got, routes=None, lm=True):
    """The launch counts set to 0 on entry and read into ``got`` on exit
    (and, given ``routes``, each routed kernel's launches per route);
    ``lm``: as ``read_counts``."""
    fns = kernel_fns()
    zero_counts(fns)
    try:
        yield
    finally:
        got.update(read_counts(fns, lm))
        if routes is not None:
            routes.update({name: dict(fns[name].routes) for name in ROUTED})


def leaf_names(tree, prefix=""):
    """The names of ``tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix
                                    else k)]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def train_setup(torch, cfg, opt=None, perturbed=True):
    """Seeded params (perturbed as in phase 4) as autograd leaves, and the
    optimizer state when ``opt`` is given: ``{"params", "opt"}``."""
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import init_opt_state, tree_leaves

    params = build_model(cfg).init_params(SEED)
    if perturbed:
        perturb(torch, params, SEED + 1)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params}
    if opt is not None:
        state["opt"] = init_opt_state(opt, params)
    return state


def train_stream(cfg):
    from repro_torch.data.synthetic import TokenStream, TokenStreamSpec
    return TokenStream(TokenStreamSpec(cfg.vocab_size, TRAIN_S + 1, TRAIN_B,
                                       SEED))


def train_bf16_grads(torch):
    """(a) qwen2.5-3b at full width and depth in bf16: one loss and grads
    on the hopper lowering (exact launch counts) against the reference
    lowering from the same params, beside the reference's own gap to the
    reference in f32 on the same (bf16-valued) weights.  Returns the
    hopper run's launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import make_batch
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_arch("qwen2.5-3b")
    t0 = time.perf_counter()
    params = train_setup(torch, cfg)["params"]
    batch = make_batch(train_stream(cfg), 0, torch.device("cuda"))
    got, rt = {}, {}
    with use_backend("hopper"), counting(got, rt):
        loss_h, g_h = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    want = train_per_step(cfg)
    if got != want:
        raise SystemExit(f"chip_smoke: train (a): launches {got}, expected "
                         f"{want}")
    # the forward and its rematerialization on the tensor-core kernel: the
    # grads below are fed by its out and lse
    if rt["flash_attention"]["tc"] != want["flash_attention"]:
        raise SystemExit(f"chip_smoke: train (a): flash_attention routes "
                         f"{rt['flash_attention']}, expected tc "
                         f"{want['flash_attention']}")
    with use_backend("reference"):
        loss_r, g_r = loss_and_grads(cfg, params, batch)
    p32 = tree_map(lambda p: p.detach().float().requires_grad_(True), params)
    with use_backend("reference"):
        loss_32, g_32 = loss_and_grads(
            dataclasses.replace(cfg, dtype="float32"), p32, batch)
    del p32
    names = leaf_names(params)
    gh, gr, g32 = (tree_leaves(t) for t in (g_h, g_r, g_32))
    hop = [rel_l2(a, b) for a, b in zip(gh, gr)]
    own = [rel_l2(a, b) for a, b in zip(gr, g32)]
    hop32 = [rel_l2(a, b) for a, b in zip(gh, g32)]
    lh, lr, l32 = (x.item() for x in (loss_h, loss_r, loss_32))
    print(f"[7 train] (a) {cfg.name} bf16, {cfg.n_layers} layers, B "
          f"{TRAIN_B} x S {TRAIN_S}, one loss and grads in "
          f"{time.perf_counter() - t0:.1f} s: loss hopper {lh:.6f}, "
          f"reference {lr:.6f} (gap {abs(lh - lr):.3g}), reference in f32 "
          f"{l32:.6f} (its own bf16 gap {abs(lr - l32):.3g}); launches "
          f"{got}; flash_attention routes {rt['flash_attention']}",
          flush=True)
    # one line per parameter: its relative L2 gap in every layer
    groups = {}
    for i, n in enumerate(names):
        groups.setdefault(n.split("]")[-1].lstrip(".") if "[" in n else n,
                          []).append(i)
    for key, idx in groups.items():
        print(f"[7 train] (a) grad {key:9s} rel L2 per layer, hopper vs "
              "reference / reference bf16 vs f32: "
              + " ".join(f"{hop[i]:.1e}/{own[i]:.1e}" for i in idx)
              + f" | hopper vs f32: max {max(hop32[i] for i in idx):.2e}",
              flush=True)
    worst = max(range(len(hop)), key=lambda i: hop[i])
    print(f"[7 train] (a) worst leaf {names[worst]}: hopper vs reference "
          f"{hop[worst]:.3g} (tolerance {BF16_GRAD_TOL}), reference bf16 vs "
          f"f32 {own[worst]:.3g}, hopper vs f32 {hop32[worst]:.3g}; over all "
          f"leaves hopper vs f32 / reference vs f32 at most "
          f"{max(a / max(b, 1e-30) for a, b in zip(hop32, own)):.3g}",
          flush=True)
    if not (all(np.isfinite(hop)) and max(hop) <= BF16_GRAD_TOL
            and abs(lh - lr) <= BF16_LOSS_TOL * abs(lr)):
        raise SystemExit("chip_smoke: train (a): bf16 grads or loss, hopper"
                         " vs reference, beyond tolerance")
    del params, g_h, g_r, g_32, gh, gr, g32
    torch.cuda.empty_cache()
    return got


def train_loop_phase(torch):
    """(b) ``launch/train.py``'s loop: ``TRAIN_STEPS`` AdamW steps of
    qwen2.5-3b at full width and depth, bf16, on the hopper lowering, each
    under ``set_sync_debug_mode("error")`` (the logged loss read aside)
    with exact launch counts, every bf16 gemm and attention backward on
    its tensor-core route; then one more step under the profiler for the
    device's busy share, and one in its two halves (loss and grads, the
    AdamW update) on the host clock.  Returns the launches of the counted
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.launch.steps import (
        init_train_state,
        loss_and_grads,
        make_train_step,
    )
    from repro_torch.launch.train import make_batch, train_loop
    from repro_torch.optim.optimizers import (
        OptConfig,
        apply_updates,
        tree_leaves,
    )

    cfg = get_arch("qwen2.5-3b")
    # launch/train.py's schedule: 10 warmup steps
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt, SEED)
    torch.cuda.synchronize()
    print(f"[7 train] (b) {cfg.name}: train state (bf16 params, f32 master, "
          f"m, v) in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    stream, step_fn = train_stream(cfg), make_train_step(cfg, opt)
    want, counts, routes = train_per_step(cfg), [], []
    # every gemm of a bf16 step on the tensor-core kernel (M = 512 and the
    # weight gradients' x.T), every attention forward and backward on the
    # tensor-core kernels, every RMSNorm forward and backward and every
    # bias on the vector kernels
    want_routes = {"gemm": want["gemm"],
                   "flash_attention_bwd": want["flash_attention_bwd"],
                   "flash_attention": want["flash_attention"],
                   "rmsnorm_bwd": want["rmsnorm_bwd"],
                   "rmsnorm": want["rmsnorm"],
                   "bias_add_rows": want["bias_add_rows"]}

    def counted(st, batch):
        got, rt = {}, {}
        with use_backend("hopper"), counting(got, rt):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step_fn(st, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                counts.append(got)
                routes.append(rt)

    total = {name: 0 for name in KERNELS}
    losses = []
    for rec in train_loop(counted, state, stream, steps=TRAIN_STEPS,
                          device=dev):
        got, rt = counts[-1], routes[-1]
        print(f"[7 train] (b) step {rec['step']}: loss {rec['loss']:.6f}, "
              f"{rec['ms']:.1f} ms/step, {rec['tokens_per_s']:.1f} tok/s, "
              f"peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB; launches {got}; "
              f"routes {rt}", flush=True)
        if got != want:
            raise SystemExit(f"chip_smoke: train (b): step {rec['step']} "
                             f"launches {got}, expected {want}")
        on_tc = {"gemm": rt["gemm"]["tc"] + rt["gemm"]["tc_splitk"],
                 "flash_attention_bwd": rt["flash_attention_bwd"]["tc"],
                 "flash_attention": rt["flash_attention"]["tc"],
                 "rmsnorm_bwd": rt["rmsnorm_bwd"]["vec"],
                 "rmsnorm": rt["rmsnorm"]["vec"],
                 "bias_add_rows": rt["bias_add_rows"]["vec"]}
        if on_tc != want_routes:
            raise SystemExit(f"chip_smoke: train (b): step {rec['step']} "
                             f"launches on the tensor-core and vector "
                             f"routes {on_tc}, expected {want_routes}")
        losses.append(rec["loss"])
        for name in KERNELS:
            total[name] += got[name]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"chip_smoke: train (b): losses {losses}")
    batch = make_batch(stream, TRAIN_STEPS, dev)
    torch.cuda.synchronize()
    with use_backend("hopper"), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        rec = {"step": TRAIN_STEPS + 1, "loss": float(loss),
               "ms": 1e3 * (time.perf_counter() - t0)}
    events = sorted(prof.key_averages(),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3   # ms
    print(f"[7 train] (b) profiled step {rec['step']}: loss "
          f"{rec['loss']:.6f}, {rec['ms']:.1f} ms wall under the profiler, "
          f"device busy {busy:.1f} ms ({100 * busy / rec['ms']:.1f}%); top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in events[:6]), flush=True)
    # where the wall time goes when the device waits for the host: one more
    # step in its two halves (the step's own loss_and_grads, then
    # apply_updates), each on the host clock as enqueued and as drained
    batch = make_batch(stream, TRAIN_STEPS + 1, dev)
    torch.cuda.synchronize()
    with use_backend("hopper"):
        t0 = time.perf_counter()
        _, grads = loss_and_grads(cfg, state["params"], batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        apply_updates(opt, grads, state["opt"], state["params"])
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    print(f"[7 train] (b) step {TRAIN_STEPS + 2} in halves, host clock: loss "
          f"and grads enqueued in {1e3 * (t1 - t0):.1f} ms, done at "
          f"{1e3 * (t2 - t0):.1f} ms; the AdamW update over "
          f"{len(tree_leaves(grads))} leaves enqueued in "
          f"{1e3 * (t3 - t2):.1f} ms, done at {1e3 * (t4 - t2):.1f} ms",
          flush=True)
    del state, step_fn, grads
    torch.cuda.empty_cache()
    return total


def close_state(torch, hop, ref, steps_taken, lr, unsettled):
    """Params, master, m and v of two train states, leaf by leaf.  The
    moments within rtol 2e-3 and 5e-5 of the leaf's largest value after
    one step (this holds the gradients: m = 0.1 * clip * g), 1e-3 after
    more.  Params and master within ``rtol=2e-3, atol=5e-5`` (the JAX
    package's own tolerance for two accumulation orders,
    ``tests/test_system.py``), with one exception, element by element:
    Adam moves a weight by lr * m / sqrt(v), so where the two sides' first
    moments differ by more than atol / lr (5%) of the reference's, which
    happens where a gradient sits at the summation noise, the updates may
    differ by up to two learning rates a step.  ``unsettled`` (leaf index
    -> bool tensor, kept by the caller across steps) gains those elements;
    every other element is held with no exception
    (``tests/test_torch_train.py``).  Returns (failures, per leaf with an
    element outside the tolerance: (tree, leaf index, elements outside,
    of which unsettled, largest gap))."""
    from repro_torch.optim.optimizers import tree_leaves

    def leaves(state, key):
        return tree_leaves(state["params"] if key == "params"
                           else state["opt"][key])

    for i, (a, b) in enumerate(zip(leaves(hop, "m"), leaves(ref, "m"))):
        far = (a - b).abs() > (5e-5 / lr) * b.abs()
        unsettled[i] = unsettled[i] | far if i in unsettled else far
    fails, rows = [], []
    for key in ("params", "master", "m", "v"):
        for i, (a, b) in enumerate(zip(leaves(hop, key), leaves(ref, key))):
            a, b = a.detach().float(), b.detach().float()
            if key in ("params", "master"):
                atol, may_miss = 5e-5, unsettled[i]
            else:
                atol = (5e-5 if steps_taken == 1 else 1e-3) * \
                    b.abs().max().item()
                may_miss = torch.zeros_like(b, dtype=torch.bool)
            gap = (a - b).abs()
            out = gap > atol + 2e-3 * b.abs()
            n = int(out.sum().item())
            if not n:
                continue
            excused = out & may_miss
            n_ex = int(excused.sum().item())
            big = gap[out].max().item()
            rows.append((key, i, n, n_ex, big))
            budget = 2 * lr * steps_taken
            if n_ex < n or (n_ex and gap[excused].max().item() > budget):
                fails.append((key, i, n, n_ex, big))
    return fails, rows


def train_f32(torch):
    """(c) qwen2.5-3b and mamba2-2.7b (the SSD scan's backward bridge) in
    f32 at full width and 2 layers: one loss and grads (exact launch
    counts), then 2 ``make_train_step`` steps, hopper against reference
    from the same train state.  Returns the hopper runs' launches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import use_backend
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.optim.optimizers import OptConfig, tree_leaves, tree_map

    dev = torch.device("cuda")
    total = {name: 0 for name in KERNELS}
    failed = []
    for arch in ("qwen2.5-3b", "mamba2-2.7b"):
        cfg = dataclasses.replace(get_arch(arch), n_layers=2,
                                  dtype="float32")
        opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        hop = train_setup(torch, cfg, opt)
        ref = {"params": tree_map(
                   lambda p: p.detach().clone().requires_grad_(True),
                   hop["params"]),
               "opt": tree_map(lambda t: t.clone(), hop["opt"])}
        stream = train_stream(cfg)
        batch = make_batch(stream, 0, dev)
        got, rt = {}, {}
        with use_backend("hopper"), counting(got, rt):
            lh, gh = loss_and_grads(cfg, hop["params"], batch)
        want = train_per_step(cfg)
        # the forward and its rematerialization scan whole sequences: on
        # "split"
        want_ssd = ssd_routes(cfg, 0, 0, forwards=2)
        if rt["ssd_scan"] != want_ssd:
            failed.append(f"{arch}: ssd_scan routes {rt['ssd_scan']}, "
                          f"expected {want_ssd}")
        # f32 keeps the IEEE kernels: no launch on a tensor-core route
        if (rt["gemm"]["tc"] + rt["gemm"]["tc_splitk"]
                + rt["flash_attention_bwd"]["tc"]
                + rt["flash_attention"]["tc"]):
            failed.append(f"{arch}: f32 launches on a tensor-core route "
                          f"{rt}")
        with use_backend("reference"):
            lr_, gr = loss_and_grads(cfg, ref["params"], batch)
        names = leaf_names(hop["params"])
        gaps = [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(tree_leaves(gh), tree_leaves(gr))]
        worst = max(range(len(gaps)), key=lambda i: gaps[i])
        lgap = abs(lh.item() - lr_.item()) / abs(lr_.item())
        print(f"[7 train] (c) {cfg.name} f32, 2 layers: loss hopper "
              f"{lh.item():.7f}, reference {lr_.item():.7f} (relative gap "
              f"{lgap:.3g}); grads within {gaps[worst]:.3g} of each leaf's "
              f"largest value (worst {names[worst]}; tolerance "
              f"{F32_GRAD_TOL}); launches {got}", flush=True)
        if got != want:
            failed.append(f"{arch}: launches {got}, expected {want}")
        if not (lgap <= F32_LOSS_TOL and gaps[worst] <= F32_GRAD_TOL):
            failed.append(f"{arch}: loss or grads")
        for key, n in got.items():
            total[key] += n
        del gh, gr
        step_fn = make_train_step(cfg, opt)
        unsettled = {}
        for step in range(2):
            batch = make_batch(stream, step, dev)
            with use_backend("hopper"):
                hop, l_h = step_fn(hop, batch)
            with use_backend("reference"):
                ref, l_r = step_fn(ref, batch)
            lgap = abs(l_h.item() - l_r.item()) / abs(l_r.item())
            fails, rows = close_state(torch, hop, ref, step + 1, opt.lr,
                                      unsettled)
            n_uns = sum(int(u.sum().item()) for u in unsettled.values())
            n_all = sum(u.numel() for u in unsettled.values())
            print(f"[7 train] (c) {cfg.name} f32, step {step + 1}: loss "
                  f"hopper {l_h.item():.7f}, reference {l_r.item():.7f} "
                  f"(relative gap {lgap:.3g}); leaves of params, master, m, "
                  f"v with elements outside the tolerance (elements, of "
                  f"which unsettled, largest gap): " + ("; ".join(
                      f"{key} {names[i]} {n}/{b.numel()} ({n_ex}) "
                      f"{big:.3g}" for key, i, n, n_ex, big in rows
                      for b in [tree_leaves(hop["params"])[i]]) or "none")
                  + f"; unsettled elements {n_uns} of {n_all}; failing: "
                  f"{fails}", flush=True)
            if lgap > F32_LOSS_TOL or fails:
                failed.append(f"{arch}: step {step + 1}")
        del hop, ref, unsettled
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: train (c): {failed}")
    return total


def phase_train(torch):
    """Phase 7; returns the launches of its hopper runs."""
    total = {name: 0 for name in KERNELS}
    for part in (train_bf16_grads, train_loop_phase, train_f32):
        for name, n in part(torch).items():
            total[name] += n
    return total



# ---------------------------------------------------------------------------
# phase 8: the Caffe forward (Caffe's TEST phase) through the port's Solver
# ---------------------------------------------------------------------------

# kernel launches of one forward at batch 64: each convolution an im2col
# and a gemm, each inner product a gemm and a bias add, each max pool and
# relu one launch, the loss one softmax_xent (CIFAR's average pools and
# the accuracy are plain torch, reference-only as in JAX); the deploy form
# runs MNIST's layers without labels, so its loss and accuracy are skipped
# and its prob is one softmax
CAFFE_LAUNCHES = {
    "lenet-mnist": dict(im2col=2, gemm=4, bias_add_rows=2, maxpool=2,
                        relu=1, softmax_xent=1),
    "lenet-cifar10": dict(im2col=3, gemm=5, bias_add_rows=2, maxpool=1,
                          relu=3, softmax_xent=1),
    "lenet-mnist-deploy": dict(im2col=2, gemm=4, bias_add_rows=2, maxpool=2,
                               relu=1, softmax=1),
}
# forwards timed per net and boundary mode
CAFFE_REPS = 20


def caffe_gemm_routes(spec, shapes, train, transpose=False):
    """The gemm's launches per route in one forward (or, ``train``, one
    autograd train step) of the net ``spec`` at blob ``shapes``: each
    product's route from ``kernels/gemm.py:plan`` at its shape and operand
    layout.  A convolution's forward w @ cols (both along their rows), dw =
    dy_flat @ cols^T (B along K) and, where its input needs a gradient,
    dcols = w^T @ dy_flat (A along M); an inner product's x @ W, db = x^T
    @ g (A along M) and, where its input needs one, da = g @ W^T (B along
    K).  With ``transpose`` (the ``transfer+transpose`` crossings) a 2-D
    bottom arrives column-major: the inner product reads x along M and
    x^T along K.  Every forward, dw and da product must take the f32
    small-M kernel."""
    import torch

    from repro_torch.kernels.gemm import plan

    routes = {}

    def add(m, n, k, a_m, b_k, small):
        route = plan(m, n, k, torch.float32, a_m_contiguous=a_m,
                     b_k_contiguous=b_k, tc_aligned=True).route
        if small:
            want_route("gemm", route, SMALL_ROUTES)
        routes[route] = routes.get(route, 0) + 1

    for ls in spec.layers:
        if ls.type not in ("Convolution", "InnerProduct"):
            continue
        bottom, top = shapes[ls.bottoms[0]], shapes[ls.tops[0]]
        grad_in = ls.bottoms[0] != "data"
        if ls.type == "Convolution":
            r = bottom[1] * ls.kernel_size ** 2
            cols = top[0] * top[2] * top[3]
            add(ls.num_output, cols, r, False, False, True)
            if train:
                add(ls.num_output, r, cols, False, True, True)
                if grad_in:
                    add(r, cols, ls.num_output, True, False, False)
        else:
            n, k = bottom[0], math.prod(bottom[1:])
            col = transpose and len(bottom) == 2
            add(n, ls.num_output, k, col, False, True)
            if train:
                add(k, ls.num_output, n, not col, False, False)
                if grad_in:
                    add(n, k, ls.num_output, False, True, True)
    return routes


def caffe_counted(torch, fn, name, synced=True, want=None, routes=None,
                  kernel_routes=None):
    """``fn()`` on the hopper backend with the counts set to 0 just before
    and read just after (under ``set_sync_debug_mode("error")`` unless the
    boundary mode syncs by design); the counts must be ``want``, by
    default one forward's of the net ``name``, the gemm's launches per
    route ``routes`` (``caffe_gemm_routes``) where given, and each kernel
    of ``kernel_routes`` (name -> {route: launches}) its launches per
    route."""
    from repro_torch.core.policy import use_backend

    if want is None:
        want = dict(CAFFE_LAUNCHES[name])
    got, rt = {}, {}
    with use_backend("hopper"), counting(got, rt, lm=False):
        if synced:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = {k: want.get(k, 0) for k in KERNELS}
    if got != want:
        raise SystemExit(f"chip_smoke: {name}: launches {got}, expected "
                         f"{want}")
    took = {r: c for r, c in rt["gemm"].items() if c}
    if routes is not None:
        if took != routes:
            raise SystemExit(f"chip_smoke: {name}: gemm launches per route "
                             f"{took}, expected {routes}")
        print(f"[caffe routes] {name}: gemm launches per route {took}, as "
              "plan names them", flush=True)
    for kernel, expect in (kernel_routes or {}).items():
        took = {r: c for r, c in rt[kernel].items() if c}
        if took != expect:
            raise SystemExit(f"chip_smoke: {name}: {kernel} launches per "
                             f"route {took}, expected {expect}")
        print(f"[caffe routes] {name}: {kernel} launches per route {took}",
              flush=True)
    return out, got


def caffe_net(torch, mk_net, mk_solver, stream_fn):
    """The net, its solver and the solver's initial params on the card
    (seeded; biases perturbed with seeded noise, as the JAX init leaves
    them 0), and batch 0 of the port's image stream on the card."""
    from repro_torch.caffe import Net, Solver

    net = Net(mk_net())
    solver = Solver(net, mk_solver())
    params = solver.init(torch.Generator().manual_seed(SEED))["params"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for p in params.values():
        if "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen,
                                       device="cuda")
    data, label = stream_fn(solver.spec.batch_size, seed=SEED).batch(0)
    return net, solver, params, data, label


def caffe_profile(torch, fwd, name, reps=10, tag="8 caffe",
                  what="forward"):
    """``reps`` calls of ``fwd`` (a forward, or a train step) on the hopper
    backend under the profiler: the device's busy share of the wall time
    and the kernels that take it (L2 warm, as in a real run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import use_backend

    with use_backend("hopper"), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = sorted(prof.key_averages(),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3   # ms
    print(f"[{tag}] {name}: {reps} {what}s under the profiler: "
          f"{wall / reps:.4f} ms wall a {what}, device busy "
          f"{busy / reps:.4f} ms ({100 * busy / wall:.1f}%); per {what}: "
          + "; ".join(f"{e.key[:48]} "
                      f"{e.self_device_time_total / 1e3 / reps:.4f} ms "
                      f"x{e.count // reps}" for e in events[:8]),
          flush=True)
    return events


def phase_caffe(torch):
    """Phase 8: LeNet-MNIST and LeNet-CIFAR-10 quick at batch 64 in f32
    through ``Solver.make_eval_step`` on the hopper backend, with exact
    launch counts and no host sync inside a forward, held against the
    reference backend (loss within 1e-5 relative, logits within 1e-4 of
    their scale, accuracy equal unless a reference top-2 gap under 1e-4
    explains it); MNIST's deploy form (a Softmax ``prob`` on ``ip2``)
    through ``Net.forward`` without labels in the three boundary modes,
    prob within 1e-5 of the fused reference's; then each
    net in the paper's three boundary modes, whose losses must agree
    within 1e-6 relative, with ms per forward.  Returns the launches of
    the counted hopper runs."""
    from repro_torch.caffe import (LayerSpec, Net, lenet_cifar10,
                                   lenet_cifar10_solver, lenet_mnist,
                                   lenet_mnist_solver)
    from repro_torch.core.policy import use_backend
    from repro_torch.data.synthetic import cifar10_like, mnist_like
    from repro_torch.kernels import ops

    total = {name: 0 for name in KERNELS}

    def add(got):
        for k, v in got.items():
            total[k] += v

    nets = {}
    for mk_net, mk_solver, stream_fn in (
            (lenet_mnist, lenet_mnist_solver, mnist_like),
            (lenet_cifar10, lenet_cifar10_solver, cifar10_like)):
        net, solver, params, data, label = caffe_net(torch, mk_net,
                                                     mk_solver, stream_fn)
        name = net.spec.name
        nets[name] = (mk_net, params, data, label, net.blob_shapes)
        eval_step = solver.make_eval_step()
        m_h, got = caffe_counted(
            torch, lambda: eval_step(params, data, label), name,
            routes=caffe_gemm_routes(net.spec, net.blob_shapes, False),
            kernel_routes=caffe_fwd_routes(net.spec, None))
        add(got)
        with use_backend("reference"):
            m_r = eval_step(params, data, label)
        logits = {}
        for backend in ("hopper", "reference"):
            with use_backend(backend), torch.no_grad():
                logits[backend] = net.forward(params, data, label,
                                              train=False)[0]["ip2"]
        lh, lr = logits["hopper"], logits["reference"]
        scale = lr.abs().max().item()
        l_gap = (lh - lr).abs().max().item()
        loss_h, loss_r = m_h["loss"].item(), m_r["loss"].item()
        acc_h, acc_r = m_h["accuracy"].item(), m_r["accuracy"].item()
        loss_gap = abs(loss_h - loss_r) / abs(loss_r)
        print(f"[8 caffe] {name}: batch {data.shape[0]}, f32, "
              f"{sum(p.numel() for q in params.values() for p in q.values())}"
              f" params: loss hopper {loss_h:.7f}, reference {loss_r:.7f} "
              f"(gap {loss_gap:.3g} relative); logits max gap {l_gap:.3g} of"
              f" scale {scale:.3g}; accuracy {acc_h} vs {acc_r}; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if not (np.isfinite(loss_h) and torch.isfinite(lh).all()
                and lh.shape == (LENET_B, 10)):
            raise SystemExit(f"chip_smoke: {name}: non-finite or malformed "
                             "outputs")
        if loss_gap > 1e-5 or l_gap > 1e-4 * scale:
            raise SystemExit(f"chip_smoke: {name}: hopper and reference "
                             "disagree beyond the tolerances")
        if acc_h != acc_r:
            top2 = lr.topk(2, dim=-1).values
            split = (lh.argmax(-1) != lr.argmax(-1)).nonzero()[:, 0]
            gaps = (top2[split, 0] - top2[split, 1]).tolist()
            print(f"[8 caffe] {name}: argmax differs in rows "
                  f"{split.tolist()}, reference top-2 gaps {gaps}",
                  flush=True)
            if not gaps or max(gaps) >= 1e-4:
                raise SystemExit(f"chip_smoke: {name}: accuracy differs "
                                 "without a near tie")

    # the deploy form (Caffe's lenet.prototxt): a Softmax prob on ip2, run
    # without labels
    mk_net, params, data, _, shapes = nets["lenet-mnist"]
    spec = mk_net()
    deploy = Net(dataclasses.replace(
        spec, name="lenet-mnist-deploy", layers=spec.layers + (LayerSpec(
            name="prob", type="Softmax", bottoms=("ip2",),
            tops=("prob",)),)))

    def deploy_prob(net):
        with torch.no_grad():
            return net.forward(params, data)[0]["prob"]

    with use_backend("reference"):
        p_r = deploy_prob(deploy)
    # in each boundary mode: the prob's softmax on "rows" where its bottom
    # arrives row-major, on "strided" from the transposed crossing
    for boundary in (None, "transfer", "transfer+transpose"):
        net = deploy if boundary is None else Net(deploy.spec,
                                                  boundary=boundary)
        p_h, got = caffe_counted(
            torch, lambda: deploy_prob(net), "lenet-mnist-deploy",
            synced=boundary is None,
            routes=caffe_gemm_routes(
                deploy.spec, shapes, False,
                transpose=boundary == "transfer+transpose"),
            kernel_routes=caffe_fwd_routes(deploy.spec, boundary,
                                           labels=False))
        add(got)
        gap = (p_h - p_r).abs().max().item()
        rows = p_h.sum(-1)
        print(f"[8 caffe] lenet-mnist-deploy ({boundary or 'fused'}): prob "
              f"{tuple(p_h.shape)} max gap {gap:.3g}, row sums "
              f"{rows.min().item():.7f}..{rows.max().item():.7f}; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if not (gap <= 1e-5 and torch.isfinite(p_h).all()):
            raise SystemExit(f"chip_smoke: lenet-mnist-deploy "
                             f"({boundary}): prob disagrees")

    # under grad the four training ops run through their autograd
    # Functions (whose backwards launch the backward kernels, phase 9);
    # softmax and im2col, which JAX's Pallas port does not differentiate
    # either, raise rather than cut the graph
    x = data[:2].clone().requires_grad_(True)
    logits = x.reshape(2, -1)[:, :10]
    lab = torch.zeros(2, dtype=torch.int64, device="cuda")
    w = torch.zeros((4, 1, 5, 5), device="cuda", requires_grad=True)
    with use_backend("hopper"):
        for what, fn, want in (
                ("relu", lambda: ops.relu(x), ops.ReluFn),
                ("conv2d", lambda: ops.conv2d(x, w), ops.Conv2dFn),
                ("maxpool", lambda: ops.maxpool(x, 2, 2), ops.MaxPoolFn),
                ("softmax_xent", lambda: ops.softmax_xent_loss(logits, lab),
                 ops.XentFn)):
            if type(fn().grad_fn).__name__ != f"{want.__name__}Backward":
                raise SystemExit(f"chip_smoke: ops.{what} under grad did "
                                 f"not go through {want.__name__}")
        for what, fn in (("softmax", lambda: ops.softmax(logits)),
                         ("im2col", lambda: ops.im2col(x, 5, 5))):
            try:
                fn()
            except RuntimeError as e:
                if "requires grad" not in str(e):
                    raise
            else:
                raise SystemExit(f"chip_smoke: ops.{what} ran its kernel "
                                 "under grad")
    print("[8 caffe] under grad relu, conv2d, maxpool and softmax_xent run "
          "through their Functions; softmax and im2col raise", flush=True)

    # the paper's §4.3 boundary modes: the forward half of its Table 2
    for name, (mk_net, params, data, label, shapes) in nets.items():
        losses, ms = {}, {}
        for boundary in (None, "transfer", "transfer+transpose"):
            net = Net(mk_net(), boundary=boundary)

            def fwd():
                with torch.no_grad():
                    return net.metrics(params, data, label)["loss"]

            loss, got = caffe_counted(
                torch, fwd, name, synced=boundary is None,
                routes=caffe_gemm_routes(
                    net.spec, shapes, False,
                    transpose=boundary == "transfer+transpose"),
                kernel_routes=caffe_fwd_routes(net.spec, boundary))
            add(got)
            losses[boundary] = loss.item()
            with use_backend("hopper"):
                for _ in range(3):
                    fwd()
                times = []
                for _ in range(CAFFE_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fwd()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
            ms[boundary] = statistics.median(times)
            if boundary is None:
                caffe_profile(torch, fwd, name)
        base = losses[None]
        print(f"[8 caffe] {name}: ms per forward (median of {CAFFE_REPS}, "
              f"host clock, batch {LENET_B}): "
              + ", ".join(f"{b or 'fused'} {ms[b]:.4f} ms "
                          f"({ms[b] / ms[None]:.2f}x, loss {losses[b]:.7f})"
                          for b in ms), flush=True)
        if any(abs(v - base) > 1e-6 * abs(base) for v in losses.values()):
            raise SystemExit(f"chip_smoke: {name}: the boundary modes give "
                             f"different losses {losses}")
    return total


# ---------------------------------------------------------------------------
# phase 9: Caffe's TRAIN phase through the port's Solver
# ---------------------------------------------------------------------------

# (a) hopper against the reference lowering in f32: the loss within 1e-5
# relative, each grad leaf within 1e-6 of its largest value.  Both sides
# are IEEE f32 and differ only in the order of their sums (the kernels'
# against cuBLAS's; the plain scatters of CIFAR's overlapping max pool and
# average pools add with atomics, in no fixed order): the largest such gap
# of the sound runs on an H100 was 3.75e-7.  A control holds the reference
# lowering with TF32 products against itself in f32 and must read above
# the tolerance, so that a product rounded to TF32 (or coarser, bf16)
# cannot pass.  The explicit backward against autograd within JAX's own
# rtol 2e-3 / atol 3e-5 (tests/test_caffe.py:207).  (b) the states after
# the steps, and one step in each crossing mode against the fused step:
# each param and velocity leaf within 1e-6 of its largest value, as the
# grads
CAFFE_LOSS_TOL, CAFFE_GRAD_TOL = 1e-5, 1e-6
MANUAL_RTOL, MANUAL_ATOL = 2e-3, 3e-5
CAFFE_TRAIN_STEPS = 3
# (c) LeNet-MNIST at batch 64 through Solver.solve
CAFFE_SOLVE_ITERS, CAFFE_TEST_INTERVAL = 300, 100


def caffe_train_launches(spec):
    """Kernel launches of one train step (autograd of ``forward_loss``)
    from the net's spec: each convolution runs im2col and a gemm forward,
    im2col again and the dw gemm backward and, where its input needs a
    gradient (every layer's but conv1's, which reads the data), the dcols
    gemm and, at stride 1, col2im; each inner product a gemm and a bias
    add forward and two gemms backward (one where its input is the data);
    each max pool its kernel forward and, where the windows do not
    overlap, maxpool_bwd (an overlapping pool's backward is the plain
    scatter); each relu relu and relu_bwd; the loss softmax_xent and
    softmax_xent_bwd.  Average pools, the accuracy, the biases' gradients
    and the update are plain torch."""
    want = {k: 0 for k in KERNELS}
    for ls in spec.layers:
        grad_in = ls.bottoms[0] != "data"
        if ls.type == "Convolution":
            want["im2col"] += 2
            want["gemm"] += 2 + grad_in
            want["col2im"] += int(grad_in and ls.stride == 1)
        elif ls.type == "InnerProduct":
            want["gemm"] += 2 + grad_in
            want["bias_add_rows"] += int(ls.bias_term)
        elif ls.type == "Pooling" and ls.pool == "max":
            want["maxpool"] += 1
            want["maxpool_bwd"] += int(ls.stride >= ls.kernel_size)
        elif ls.type == "ReLU":
            want["relu"] += 1
            want["relu_bwd"] += 1
        elif ls.type == "SoftmaxWithLoss":
            want["softmax_xent"] += 1
            want["softmax_xent_bwd"] += 1
    return want


def caffe_maxpool_routes(spec, boundary):
    """``maxpool``'s launches per route in one forward or train step of
    the net ``spec`` (one a max Pooling layer) in the boundary mode:
    "plane" where its bottom arrives row-major (the fused net;
    ``transfer``, whose crossings copy without a relayout), "strided" in
    ``transfer+transpose``, whose crossing hands every layer a
    column-major bottom."""
    n = sum(ls.type == "Pooling" and ls.pool == "max" for ls in spec.layers)
    route = "strided" if boundary == "transfer+transpose" else "plane"
    return {"maxpool": {route: n}}


def caffe_relu_routes(spec, boundary):
    """``relu``'s launches per route in one forward or train step of the
    net ``spec`` (one a ReLU layer): "vec" in every boundary mode (the
    transposed crossing's column-major blob is dense too)."""
    return {"relu": {"vec": sum(ls.type == "ReLU" for ls in spec.layers)}}


def caffe_softmax_routes(spec, boundary):
    """``softmax``'s launches per route in one forward of the net ``spec``
    (one a Softmax layer: the deploy form's ``prob``): "rows" where its
    bottom arrives row-major (the fused net; ``transfer``), "strided" in
    ``transfer+transpose``, whose crossing hands it a column-major blob
    (``tests/test_torch_softmax_plan.py`` walks the crossings on the
    CPU)."""
    n = sum(ls.type == "Softmax" for ls in spec.layers)
    route = "strided" if boundary == "transfer+transpose" else "rows"
    return {"softmax": {route: n} if n else {}}


def caffe_xent_routes(spec, boundary, labels=True):
    """``softmax_xent``'s launches per route in one forward or train step
    of the net ``spec`` (one a SoftmaxWithLoss layer; none without
    ``labels``, as the deploy form runs): "rows" where its logits arrive
    row-major (the fused net; ``transfer``), "strided" in
    ``transfer+transpose``, whose crossing hands it a column-major blob
    (``tests/test_torch_xent_plan.py`` walks the crossings on the
    CPU)."""
    n = labels * sum(ls.type == "SoftmaxWithLoss" for ls in spec.layers)
    route = "strided" if boundary == "transfer+transpose" else "rows"
    return {"softmax_xent": {route: n} if n else {}}


def caffe_xent_bwd_routes(spec, boundary):
    """``softmax_xent_bwd``'s launches per route in one train step of the
    net ``spec`` (one a SoftmaxWithLoss layer): "rows" in every boundary
    mode, as its probs are the forward kernel's fresh contiguous output
    whichever layout the logits arrived in
    (``tests/test_torch_xent_bwd_plan.py`` walks the crossings on the
    CPU)."""
    n = sum(ls.type == "SoftmaxWithLoss" for ls in spec.layers)
    return {"softmax_xent_bwd": {"rows": n}}


def caffe_pool_bwd_routes(spec, boundary):
    """``maxpool_bwd``'s launches per route in one train step of the net
    ``spec``: "window" for each max pool whose windows do not overlap at
    a stride the kernel is instantiated for (MNIST's two 2/2 pools), in
    every boundary mode: dy comes back row-major from the next layer's
    backward and the argmax is the forward kernel's contiguous output
    (``tests/test_torch_pool_bwd_plan.py`` walks the crossings on the
    CPU); "pixel" for other non-overlapping strides; none for an
    overlapping pool (CIFAR's 3/2: the plain scatter)."""
    from repro_torch.kernels.pooling import BWD_STRIDES

    took = {}
    for ls in spec.layers:
        if ls.type == "Pooling" and ls.pool == "max" \
                and ls.stride >= ls.kernel_size:
            route = "window" if ls.stride in BWD_STRIDES else "pixel"
            took[route] = took.get(route, 0) + 1
    return {"maxpool_bwd": took}


def caffe_bias_routes(spec, boundary):
    """``bias_add_rows``'s launches per route in one forward or train step
    of the net ``spec`` (one an InnerProduct layer with a bias): "vec"
    where its f32 N is whole 16-byte vectors (LeNet's 500 and 64),
    "scalar" else (N = 10); in every boundary mode, as the bias adds to
    the product's fresh row-major top."""
    took = {}
    for ls in spec.layers:
        if ls.type == "InnerProduct" and ls.bias_term:
            route = "vec" if ls.num_output % 4 == 0 else "scalar"
            took[route] = took.get(route, 0) + 1
    return {"bias_add_rows": took}


def caffe_conv_routes(spec, boundary, train=False):
    """``im2col``'s and, in a train step (``train``), ``col2im``'s
    launches per route in one forward or train step of the net ``spec``:
    "band" for the im2col of a 3 x 3 or 5 x 5 window at stride 1 (every
    LeNet convolution), once a forward and again in the backward, in every
    boundary mode (the transposed crossing's column-major bottom is staged
    by its strides), "flat" for other windows; "tile" for the col2im of
    each such convolution whose input needs a gradient (its columns are
    the dcols product, row-major in every mode)."""
    im, col = {}, {}
    for ls in spec.layers:
        if ls.type != "Convolution":
            continue
        band = ls.kernel_size in (3, 5) and ls.stride == 1
        route = "band" if band else "flat"
        im[route] = im.get(route, 0) + (2 if train else 1)
        if train and ls.bottoms[0] != "data" and ls.stride == 1:
            route = "tile" if band else "flat"
            col[route] = col.get(route, 0) + 1
    return {"im2col": im, **({"col2im": col} if train else {})}


def caffe_fwd_routes(spec, boundary, labels=True):
    """The forward's routed Caffe kernels, ``caffe_maxpool_routes``,
    ``caffe_relu_routes``, ``caffe_softmax_routes``,
    ``caffe_xent_routes`` (the loss, where the forward has ``labels``),
    ``caffe_bias_routes`` and ``caffe_conv_routes``, for
    ``caffe_counted``'s ``kernel_routes``."""
    return {**caffe_maxpool_routes(spec, boundary),
            **caffe_relu_routes(spec, boundary),
            **caffe_softmax_routes(spec, boundary),
            **caffe_xent_routes(spec, boundary, labels),
            **caffe_bias_routes(spec, boundary),
            **caffe_conv_routes(spec, boundary)}


def caffe_relu_bwd_routes(spec, boundary):
    """``relu_bwd``'s launches per route in one train step of the net
    ``spec`` (one a ReLU layer) in the boundary mode: "vec" where x and dy
    share a layout (the fused step; ``transfer``, whose crossings copy
    without a relayout), "strided" in ``transfer+transpose``, where the
    ReLU's x arrives column-major from its crossing and its dy comes back
    row-major from the next layer's (every LeNet ReLU: each feeds a layer
    whose bottom is crossed)."""
    n = sum(ls.type == "ReLU" for ls in spec.layers)
    route = "strided" if boundary == "transfer+transpose" else "vec"
    return {"relu_bwd": {route: n}}


def caffe_leaves(params):
    """Autograd leaves sharing the params' storage, and their flat list."""
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for n, p in params.items()}
    return leaves, [v for p in leaves.values() for v in p.values()]


def caffe_fwbw(torch, net, params, data, label):
    """The fused forward + backward: autograd of ``forward_loss``; returns
    (loss, grads tree)."""
    leaves, flat = caffe_leaves(params)
    loss = net.forward_loss(leaves, data, label)
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {n: {k: next(grads) for k in p}
                           for n, p in leaves.items()}


def tree_gap(torch, got, want):
    """The largest leaf gap relative to the leaf's largest value, and the
    leaf."""
    gaps = {f"{n}.{k}": ((got[n][k] - want[n][k]).abs().max()
                         / want[n][k].abs().max().clamp_min(1e-30)).item()
            for n in want for k in want[n]}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def manual_close(torch, got, want):
    """``got`` within JAX's allclose tolerance of ``want``, leaf by leaf."""
    return all(torch.allclose(got[n][k], want[n][k], rtol=MANUAL_RTOL,
                              atol=MANUAL_ATOL)
               for n in want for k in want[n])


def caffe_timed(torch, fn, reps=CAFFE_REPS):
    """Median host-clock ms of ``fn()`` on the hopper backend, each call
    ended by a synchronize, after 3 warm-up calls."""
    from repro_torch.core.policy import use_backend

    with use_backend("hopper"):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


# the device kernels of the average pool's backward before this slice
# (autograd of the window gather: ``index_put_`` with accumulation) and
# after it (``AvgPoolFn``: aten's gather)
WINDOW_BWD_KERNELS = ("indexing_backward_kernel",)
AVGPOOL_BWD_KERNELS = ("avg_pool2d_backward",)


def caffe_avgpool_bwd(torch, events, step, name, spec, reps=10):
    """The average pools' backward in a train step of ``spec`` (from
    ``caffe_profile``'s ``events`` over ``reps`` steps): no
    ``indexing_backward_kernel``, and one aten gather a pool; then one
    step each with the window gather's autograd forced
    (``forced_windows_avgpool``, the route before this slice) and on
    ``AvgPoolFn``, under the profiler with Python stacks: which backward
    node launched each of those kernels, from which forward op, and its
    device us."""
    pools = sum(ls.type == "Pooling" and ls.pool == "ave"
                for ls in spec.layers)
    ran = [(short_kernel(e.key), e) for e in events
           if e.self_device_time_total > 0]
    old = [k for k, _ in ran if k.startswith(WINDOW_BWD_KERNELS)]
    new = [(k, e) for k, e in ran if k.startswith(AVGPOOL_BWD_KERNELS)]
    if old or sum(e.count for _, e in new) != pools * reps:
        raise SystemExit(f"chip_smoke: {name}: the average pools' backward "
                         f"ran {old + [k for k, _ in new]}, expected "
                         f"{AVGPOOL_BWD_KERNELS[0]} {pools} a step")
    if not pools:
        return
    print(f"[9 caffe train] {name}: the {pools} average pools' backward a "
          "step: " + "; ".join(f"{k} x{e.count // reps} "
                               f"{e.self_device_time_total / 1e3 / reps:.4f}"
                               " ms" for k, e in new)
          + "; no indexing_backward_kernel", flush=True)
    from repro_torch.core.policy import use_backend

    kernels = WINDOW_BWD_KERNELS + AVGPOOL_BWD_KERNELS
    with use_backend("hopper"):
        for how, ctx in (("the window gather's autograd forced",
                          forced_windows_avgpool),
                         ("AvgPoolFn", contextlib.nullcontext)):
            with ctx():
                found = backward_kernel_frames(torch, step, kernels)
            print(f"[9 caffe train] {name}, {how}: " + "; ".join(
                f"{k} from {node} ({' <- '.join(frames[:4])}) {us:.1f} us"
                for k, lst in sorted(found.items())
                for node, frames, us in lst), flush=True)


def phase_caffe_train(torch):
    """Phase 9: Caffe's TRAIN phase for LeNet-MNIST and LeNet-CIFAR-10
    quick at batch 64 in f32 on the hopper backend, seeded params with
    perturbed biases and the port's image stream on the card: (a) loss and
    grads against the reference lowering from the same params, and
    ``Net.backward_manual`` against autograd; (b) ``CAFFE_TRAIN_STEPS``
    ``make_train_step`` steps, each under ``set_sync_debug_mode("error")``
    with exact launch counts (``caffe_train_launches``), the states after
    them against the reference lowering's; (c) ``Solver.solve`` on
    LeNet-MNIST for ``CAFFE_SOLVE_ITERS`` iterations: the loss must halve
    and the test accuracy pass 0.8 (``tests/test_caffe.py:211-221``); (d)
    the paper's Table 2, forward + backward: ms per iteration in the three
    boundary modes (fused: autograd of ``forward_loss``; the crossing
    modes: ``forward_loss`` then ``backward_manual``, as
    ``benchmarks/table2_fwbw.py:31-48``), whose grads must agree, ms per
    train step and one profiled train step's busy share.  Returns the
    launches of (b)'s hopper steps, the crossing modes' included."""
    from repro_torch.caffe import (Net, Solver, lenet_cifar10,
                                   lenet_cifar10_solver, lenet_mnist,
                                   lenet_mnist_solver)
    from repro_torch.core.policy import use_backend
    from repro_torch.data.synthetic import cifar10_like, mnist_like

    total = {name: 0 for name in KERNELS}
    for mk_net, mk_solver, stream_fn in (
            (lenet_mnist, lenet_mnist_solver, mnist_like),
            (lenet_cifar10, lenet_cifar10_solver, cifar10_like)):
        net, solver, params, data, label = caffe_net(torch, mk_net,
                                                     mk_solver, stream_fn)
        name = net.spec.name
        want = caffe_train_launches(net.spec)
        # (a)
        out = {}
        for backend in ("hopper", "reference"):
            with use_backend(backend):
                out[backend] = caffe_fwbw(torch, net, params, data, label)
        (loss_h, g_h), (loss_r, g_r) = out["hopper"], out["reference"]
        loss_gap = abs(loss_h.item() - loss_r.item()) / abs(loss_r.item())
        g_gap, g_worst = tree_gap(torch, g_h, g_r)
        # the control: the same reference lowering with TF32 products
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with use_backend("reference"):
                _, g_t = caffe_fwbw(torch, net, params, data, label)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        t_gap, t_worst = tree_gap(torch, g_t, g_r)
        with use_backend("hopper"):
            manual = net.backward_manual(params, data, label)
        m_gap, m_worst = tree_gap(torch, manual, g_h)
        print(f"[9 caffe train] (a) {name}: batch {LENET_B}, f32: loss "
              f"hopper {loss_h.item():.7f}, reference {loss_r.item():.7f} "
              f"(gap {loss_gap:.3g} relative); grads hopper vs reference "
              f"within {g_gap:.3g} of each leaf's largest value (worst "
              f"{g_worst}; tolerance {CAFFE_GRAD_TOL}); control: the "
              f"reference lowering with TF32 products within {t_gap:.3g} "
              f"(worst {t_worst}); backward_manual vs autograd within "
              f"{m_gap:.3g} (worst {m_worst})", flush=True)
        if not all(torch.isfinite(g).all() for p in g_h.values()
                   for g in p.values()):
            raise SystemExit(f"chip_smoke: {name}: non-finite grads")
        if loss_gap > CAFFE_LOSS_TOL or g_gap > CAFFE_GRAD_TOL:
            raise SystemExit(f"chip_smoke: {name}: hopper and reference "
                             "grads disagree beyond the tolerances")
        if t_gap <= CAFFE_GRAD_TOL:
            raise SystemExit(f"chip_smoke: {name}: the grad tolerance does "
                             "not tell TF32 products from f32 ones")
        if not manual_close(torch, manual, g_h):
            raise SystemExit(f"chip_smoke: {name}: backward_manual and "
                             "autograd disagree beyond JAX's tolerance")

        # (b)
        def fresh():
            return {"params": {n: {k: v.clone() for k, v in p.items()}
                               for n, p in params.items()},
                    "velocity": {n: {k: torch.zeros_like(v)
                                     for k, v in p.items()}
                                 for n, p in params.items()},
                    "iter": torch.zeros((), dtype=torch.int32,
                                        device="cuda")}

        stream = stream_fn(LENET_B, seed=SEED)
        batches = [stream.batch(i) for i in range(CAFFE_TRAIN_STEPS)]
        step = solver.make_train_step()
        st_h, st_r = fresh(), fresh()
        for i, (d, lab) in enumerate(batches):
            (st_h, l_h), got = caffe_counted(
                torch, lambda: step(st_h, d, lab), name, want=want,
                routes=caffe_gemm_routes(net.spec, net.blob_shapes, True),
                kernel_routes={**caffe_relu_bwd_routes(net.spec, None),
                               **caffe_pool_bwd_routes(net.spec, None),
                               **caffe_xent_bwd_routes(net.spec, None),
                               **caffe_fwd_routes(net.spec, None),
                               **caffe_conv_routes(net.spec, None, True)})
            for k, v in got.items():
                total[k] += v
            with use_backend("reference"):
                st_r, l_r = step(st_r, d, lab)
            print(f"[9 caffe train] (b) {name} step {i + 1}: loss hopper "
                  f"{l_h.item():.7f}, reference {l_r.item():.7f}; launches "
                  f"{ {k: v for k, v in got.items() if v} }", flush=True)
        # one step in each crossing mode from the same state: the
        # Functions' kernels read the column-major blobs by their strides,
        # with the fused step's launches
        d, lab = batches[0]
        with use_backend("hopper"):
            st1, _ = step(fresh(), d, lab)
        for boundary in ("transfer", "transfer+transpose"):
            bstep = Solver(Net(mk_net(), boundary=boundary),
                           mk_solver()).make_train_step()
            st0 = fresh()
            (stb, _), got = caffe_counted(
                torch, lambda: bstep(st0, d, lab), name, synced=False,
                want=want, routes=caffe_gemm_routes(
                    net.spec, net.blob_shapes, True,
                    transpose=boundary == "transfer+transpose"),
                kernel_routes={**caffe_relu_bwd_routes(net.spec, boundary),
                               **caffe_pool_bwd_routes(net.spec, boundary),
                               **caffe_xent_bwd_routes(net.spec, boundary),
                               **caffe_fwd_routes(net.spec, boundary),
                               **caffe_conv_routes(net.spec, boundary,
                                                   True)})
            for k, v in got.items():
                total[k] += v
            gap, worst = tree_gap(torch, stb["params"], st1["params"])
            print(f"[9 caffe train] (b) {name}, {boundary}: one step's "
                  f"params within {gap:.3g} of the fused step's (worst "
                  f"{worst})", flush=True)
            if gap > CAFFE_GRAD_TOL:
                raise SystemExit(f"chip_smoke: {name}: a {boundary} train "
                                 "step differs from the fused one")
        p_gap, p_worst = tree_gap(torch, st_h["params"], st_r["params"])
        v_gap, v_worst = tree_gap(torch, st_h["velocity"], st_r["velocity"])
        print(f"[9 caffe train] (b) {name}: after {CAFFE_TRAIN_STEPS} steps "
              f"params within {p_gap:.3g} (worst {p_worst}), velocities "
              f"within {v_gap:.3g} (worst {v_worst}) of the reference "
              f"lowering's, relative to each leaf's largest value; iter "
              f"{st_h['iter'].item()}", flush=True)
        if max(p_gap, v_gap) > CAFFE_GRAD_TOL or \
                st_h["iter"].item() != CAFFE_TRAIN_STEPS:
            raise SystemExit(f"chip_smoke: {name}: train states disagree")

        # (d) Table 2, forward + backward, and the train step
        ms, grads = {}, {}
        for boundary in (None, "transfer", "transfer+transpose"):
            bnet = Net(mk_net(), boundary=boundary)
            if boundary is None:
                def fwbw(bnet=bnet):
                    return caffe_fwbw(torch, bnet, params, data, label)[1]
            else:
                def fwbw(bnet=bnet):
                    bnet.forward_loss(params, data, label)
                    return bnet.backward_manual(params, data, label)
            with use_backend("hopper"):
                grads[boundary] = fwbw()
            ms[boundary] = caffe_timed(torch, fwbw)
        if not all(manual_close(torch, grads[b], grads[None])
                   for b in ("transfer", "transfer+transpose")):
            raise SystemExit(f"chip_smoke: {name}: the boundary modes give "
                             "different grads")
        st = fresh()
        ms_step = caffe_timed(torch, lambda: step(st, data, label))
        print(f"[9 caffe train] (d) {name}: ms per forward + backward "
              f"(median of {CAFFE_REPS}, host clock, batch {LENET_B}): "
              + ", ".join(f"{b or 'fused'} {ms[b]:.4f} ms "
                          f"({ms[b] / ms[None]:.2f}x)" for b in ms)
              + f"; ms per train step (fused, update included) "
              f"{ms_step:.4f}", flush=True)
        events = caffe_profile(torch, lambda: step(st, data, label), name,
                               tag="9 caffe train", what="train step")
        caffe_avgpool_bwd(torch, events, lambda: step(st, data, label),
                          name, net.spec)

    # (c)
    solver = Solver(Net(lenet_mnist()), lenet_mnist_solver(
        max_iter=CAFFE_SOLVE_ITERS, test_interval=CAFFE_TEST_INTERVAL))
    stream = mnist_like(solver.spec.batch_size, seed=SEED)
    t0 = time.perf_counter()
    with use_backend("hopper"):
        _, hist = solver.solve(
            torch.Generator().manual_seed(SEED), iter(stream),
            test_iter=lambda: stream.eval_iter(),
            log=lambda m: print(f"[9 caffe train] (c) lenet-mnist {m}",
                                flush=True))
    secs = time.perf_counter() - t0
    first, last = hist["loss"][0], hist["loss"][-1]
    acc = hist["test_acc"][-1][1]
    print(f"[9 caffe train] (c) lenet-mnist: Solver.solve, "
          f"{CAFFE_SOLVE_ITERS} iterations at batch "
          f"{solver.spec.batch_size} in {secs:.2f} s "
          f"({1e3 * secs / CAFFE_SOLVE_ITERS:.3f} ms an iteration, the "
          f"loss read back each one and the tests included): loss {first:.4f}"
          f" -> {last:.4f}, test accuracy {acc:.4f}", flush=True)
    if not (np.isfinite(hist["loss"]).all() and last < 0.5 * first
            and acc > 0.8):
        raise SystemExit("chip_smoke: lenet-mnist: Solver.solve did not "
                         "train")
    return total


# ---------------------------------------------------------------------------
# phase 10: the direct convolution at the LeNets' convolutions
# ---------------------------------------------------------------------------

def phase_direct(torch):
    """Phase 10: for LeNet-MNIST and LeNet-CIFAR-10 at batch 64 in f32 on
    the hopper backend, the forward through ``Net.forward`` (phase 8's
    params and batch), then ``ops.conv2d_direct`` on each Convolution
    layer's bottom blob with its params, through ``dispatch``: one kernel
    launch a layer and no other, no host sync.  Each output is held to the
    layer's top blob (the net's own im2col + gemm kernels) and to
    ``ref.conv2d_direct``, within 1e-5 of its scale (sums of up to 800 f32
    products in another order).  Then ms per layer and per net for the
    direct form against the layer's im2col + gemm + bias form
    (``ops.conv2d``) on the same input: host clock, synchronized, median
    of ``CAFFE_REPS``; every im2col of the im2col + gemm form on "band".
    Returns the launches of the counted runs."""
    from repro_torch.caffe import (lenet_cifar10, lenet_cifar10_solver,
                                   lenet_mnist, lenet_mnist_solver)
    from repro_torch.core.policy import use_backend
    from repro_torch.data.synthetic import cifar10_like, mnist_like
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.im2col import im2col as im2col_k

    total = {name: 0 for name in KERNELS}
    for mk_net, mk_solver, stream_fn in (
            (lenet_mnist, lenet_mnist_solver, mnist_like),
            (lenet_cifar10, lenet_cifar10_solver, cifar10_like)):
        net, _, params, data, label = caffe_net(torch, mk_net, mk_solver,
                                                stream_fn)
        name = net.spec.name
        with use_backend("hopper"), torch.no_grad():
            blobs = net.forward(params, data, label, train=False)[0]
        convs = [(s.name, blobs[s.bottoms[0]], params[s.name]["w"],
                  params[s.name].get("b"), s.stride, s.pad, blobs[s.tops[0]])
                 for s in (layer.spec for layer in net.layers)
                 if s.type == "Convolution"]

        def direct(c):
            with torch.no_grad():
                return ops.conv2d_direct(c[1], c[2], c[3], stride=c[4],
                                         pad=c[5])

        def im2col_gemm(c):
            with torch.no_grad():
                return ops.conv2d(c[1], c[2], c[3], stride=c[4], pad=c[5])

        outs, got = caffe_counted(
            torch, lambda: [direct(c) for c in convs], name,
            want={"conv2d_direct": len(convs)},
            kernel_routes={"conv2d_direct": {"reg": len(convs)}})
        for k, v in got.items():
            total[k] += v
        for c, y in zip(convs, outs):
            layer, x, w, b, st, p, top = c
            want = ref.conv2d_direct(x, w, b, stride=st, pad=p)
            scale = top.abs().max().item()
            gap = (y - top).abs().max().item()
            gap_r = (y - want).abs().max().item()
            t_d = caffe_timed(torch, lambda c=c: direct(c))
            t_g = caffe_timed(torch, lambda c=c: im2col_gemm(c))
            print(f"[10 direct] {name} {layer}: {tuple(x.shape)} -> "
                  f"{tuple(y.shape)} k{w.shape[-1]} p{p}: max gap to the "
                  f"net's im2col + gemm top {gap:.3g}, to ref.conv2d_direct "
                  f"{gap_r:.3g}, of scale {scale:.3g}; ms (median of "
                  f"{CAFFE_REPS}, host clock): direct {t_d:.4f}, im2col + "
                  f"gemm + bias {t_g:.4f} ({t_g / t_d:.2f}x)", flush=True)
            if not (y.shape == top.shape and torch.isfinite(y).all()
                    and gap <= 1e-5 * scale
                    and gap_r <= 1e-5 * want.abs().max().item()):
                raise SystemExit(f"chip_smoke: {name} {layer}: "
                                 "conv2d_direct disagrees or is malformed")
        t_d = caffe_timed(torch, lambda: [direct(c) for c in convs])
        before = dict(im2col_k.routes)
        t_g = caffe_timed(torch, lambda: [im2col_gemm(c) for c in convs])
        took = {r for r, v in im2col_k.routes.items() if v != before[r]}
        if took != {"band"}:
            raise SystemExit(f"chip_smoke: {name}: the im2col + gemm form "
                             f"took im2col routes {took}, not band")
        print(f"[10 direct] {name}: the {len(convs)} convolutions of one "
              f"forward at batch {LENET_B} (median of {CAFFE_REPS}, host "
              f"clock): direct {t_d:.4f} ms, im2col + gemm + bias "
              f"{t_g:.4f} ms ({t_g / t_d:.2f}x; im2col on band); launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)

    # JAX's conv2d_direct_pallas has no VJP: under grad the hopper
    # lowering raises rather than cut the graph
    x = convs[0][1].detach().requires_grad_(True)
    with use_backend("hopper"):
        try:
            ops.conv2d_direct(x, *convs[0][2:4], pad=convs[0][5])
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
        else:
            raise SystemExit("chip_smoke: ops.conv2d_direct ran its kernel "
                             "under grad")
    print("[10 direct] under grad ops.conv2d_direct raises", flush=True)
    return total


if __name__ == "__main__":
    sys.exit(main())
