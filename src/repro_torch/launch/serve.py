"""Serving CLI — a thin command line over the port's continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --requests 8 --prompt-len 32 --gen 32 \\
        [--layout paged --page-size 16 --n-pages N [--kv-dtype int8]] \\
        [--prefill-chunk 16] [--check]

``--arch`` takes qwen2.5-3b, mamba2-2.7b, zamba2-2.7b, mixtral-8x7b,
qwen3-moe-235b-a22b or their ``-smoke`` variants.  ``--kv-dtype`` (paged
only) stores the page pool in the model's dtype (``f32``, the default),
``bf16`` or ``int8`` with per-(page, head) scales.  ``--n-layers`` cuts
the depth and keeps the width: mixtral-8x7b's 32 layers do not fit one
80 GB card, 16 do.  Random weights from
``--seed``, random prompts, greedy decoding through the Hopper kernels;
prints tokens/s, time per decode step, mean time to first token, the
chunked-prefill step count and, paged, the peak pages in use and the
resident KV bytes at that peak.  Runs on the card (``--device cuda``, the
default) and raises when there is none; ``--device cpu`` runs the plain
PyTorch versions.

``--check`` then holds token-by-token decode of the first ``--batch``
prompts against the teacher-forced forward at the last prompt position
(``serving/checks.py``): within 2e-2 in f32, as the JAX package holds
it, and within 5% of the largest |logit| in bf16.  It refuses the bf16
Mamba archs (mamba2-2.7b, zamba2-2.7b): with random weights their full
64- and 54-layer stacks are chaotic, so bf16 rounding alone moves the
logits by about their own scale and no tolerance can hold them (their
``-smoke`` variants, in f32, are checked).  For the moe archs the check
lifts ``capacity_factor`` to the expert count: the forward routes B*S
tokens and decode B at a time, so with capacity dropping the two drop
different tokens.

``--profile`` serves the requests a second time under ``torch.profiler``
(device activity only) and prints the device's busy share of the wall time
and the kernels that took the most device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models.model import build_model
from repro_torch.serving import CacheConfig, EngineConfig, ServingEngine
from repro_torch.serving.checks import assert_decode_matches_teacher_forced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="serve the arch at full width with this many "
                         "layers (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--layout", choices=["contiguous", "paged"],
                    default="contiguous",
                    help="KV-cache layout (paged: pool+block-table)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"],
                    default="f32",
                    help="paged pool storage: the model's dtype (f32), "
                         "bf16, or int8 with per-(page, head) scales")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size (default: batch*max_len/page_size;"
                         " a smaller pool queues requests until pages are "
                         "released)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens ingested per engine step (chunked "
                         "prefill; 1 = token-by-token)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true",
                    help="verify the decode path against the "
                         "teacher-forced forward (dense archs and the "
                         "f32 -smoke variants; refused for bf16 Mamba "
                         "stacks)")
    ap.add_argument("--profile", action="store_true",
                    help="serve again under torch.profiler and print the "
                         "device busy share and the top kernels")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if (args.check and cfg.family in ("ssm", "hybrid")
            and cfg.dtype == "bfloat16"):
        ap.error(f"--check cannot hold {cfg.name} in bf16: its random "
                 f"{cfg.n_layers}-layer Mamba stack is chaotic, so rounding "
                 f"alone moves the logits by about their scale; check "
                 f"{cfg.name}-smoke instead")
    model = build_model(cfg, device=args.device)
    params = model.init_params(args.seed)
    n_req = args.requests or args.batch
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (n_req, args.prompt_len))

    # no host tier in the port: a pool below the worst case queues
    cache = CacheConfig(layout=args.layout, page_size=args.page_size,
                        n_pages=args.n_pages, kv_dtype=args.kv_dtype,
                        host_spill=False if args.n_pages else None)
    config = EngineConfig(steps_per_sync=args.steps_per_sync,
                          prefill_chunk=args.prefill_chunk)

    def serve():
        eng = ServingEngine(
            model, params, batch=args.batch,
            max_len=args.prompt_len + args.gen + 1, cache=cache,
            config=config,
        )
        rids = [eng.submit(p, args.gen) for p in prompts]
        return eng, rids, eng.run()

    eng, rids, outs = serve()
    s = eng.stats()
    print(f"{cfg.name} on {model.device}: {n_req} requests x {args.gen} "
          f"tokens, batch {args.batch}: {s['tok_per_s']:.1f} generated tok/s, "
          f"{s['ms_per_step']:.2f} ms per step "
          f"({int(s['decode_steps'])} decode + {int(s['prefill_steps'])} "
          f"prefill steps), mean TTFT "
          f"{1e3 * s['mean_ttft_s']:.1f} ms")
    line = f"layout {args.layout}, prefill chunk {args.prefill_chunk}"
    if args.layout == "paged":
        line += f", kv dtype {args.kv_dtype}"
    if "kv_pages" in s:
        line += (f": peak pages {int(s['kv_pages_peak'])} of "
                 f"{int(s['kv_pages'])} "
                 f"({int(s['kv_resident_bytes_peak'])} bytes of KV)")
    print(line)
    print("sample:", outs[rids[0]][:16].tolist())
    if args.check:
        prompt = torch.as_tensor(prompts[: args.batch], device=model.device)
        if cfg.n_experts:
            model = dataclasses.replace(model, cfg=dataclasses.replace(
                cfg, capacity_factor=float(cfg.n_experts)))
        err, scale = assert_decode_matches_teacher_forced(
            model, params, prompt, args.prompt_len + args.gen + 1,
            scale_tol=0.05 if cfg.dtype == "bfloat16" else None)
        print(f"decode path matches teacher-forced forward (max |diff| "
              f"{err:.3g}, max |logit| {scale:.3g})")
    if args.profile:
        profile(serve)
    return 0


def profile(serve) -> None:
    """Device busy share and top kernels of one serving run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng = serve()[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e6   # us -> s
    s = eng.stats()
    steps = s["prefill_steps"] + s["decode_steps"]
    print(f"profile: wall {wall:.3f} s for {int(s['prefill_steps'])} prefill"
          f" + {int(s['decode_steps'])} decode steps "
          f"({1e3 * wall / steps:.2f} ms/step, mean TTFT "
          f"{1e3 * s['mean_ttft_s']:.1f} ms), device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    raise SystemExit(main())
