"""Serving CLI — a thin command line over the port's continuous-batching
engine, and the lockstep loop of the families the engine does not take.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --requests 8 --prompt-len 32 --gen 32 \\
        [--layout paged --page-size 16 --n-pages N [--kv-dtype int8]] \\
        [--prefill-chunk 16] [--temperature 0.8 --top-k 50] \\
        [--prefix-sharing] [--spec-k 4 --spec-drafter prompt_lookup
        --spec-ngram 2] [--check]

``--arch`` takes qwen2.5-3b, mamba2-2.7b, zamba2-2.7b, mixtral-8x7b,
qwen3-moe-235b-a22b, seamless-m4t-medium, llama-3.2-vision-90b or their
``-smoke`` variants (``get_arch`` resolves the other dense archs too).
The encdec (seamless-m4t-medium) and vlm (llama-3.2-vision-90b) families
run ``serve_lockstep``, as ``repro.launch.serve`` does: the ``--batch``
prompts decoded token by token over the contiguous slab, then greedy
generation, the argmax kept on the device; vlm attends to zero vision
embeddings and encdec to zero cross K/V, as JAX's loop does (the engine's
flags are ignored with a warning, and ``--check`` is not run).
``--n-layers`` on a vlm arch must be a multiple of its
``cross_attn_every`` (else the model raises).  ``--kv-dtype`` (paged
only) stores the page pool in the model's dtype (``f32``, the default),
``bf16`` or ``int8`` with per-(page, head) scales.  ``--n-layers`` cuts
the depth and keeps the width: mixtral-8x7b's 32 layers do not fit one
80 GB card, 16 do.  Random weights from
``--seed``, random prompts, greedy decoding through the Hopper kernels, or
sampled (``--temperature``, ``--top-k``, keyed by ``--seed`` and the
request id as in JAX); ``--prefix-sharing`` (paged) lets a request map a
resident row's written prompt pages (random prompts share none, so it
reports 0 shared tokens here; ``chip_smoke.py`` phase 11 serves a common
system prompt); ``--spec-k K`` (with ``--prefill-chunk`` >= 2, greedy)
decodes by draft and verify: ``--spec-drafter prompt_lookup`` (n-gram
lookup of ``--spec-ngram`` tokens, any family) or ``hybrid_ssm`` (the
hybrid family's own Mamba layers) drafts K tokens a row and one chunk of
width K + 1 verifies them, with the tokens of plain greedy decode; prints
tokens/s, time per decode step, mean time to first
token, the chunked-prefill step count and, paged, the peak pages in use
and the resident KV bytes at that peak, and the sharing, snapshot,
preemption and speculation counts when they apply (a pool below the worst case, set by
``--n-pages``, preempts into the host tier, as in JAX).  Runs on the card (``--device cuda``, the
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
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import encdec
from repro_torch.models.model import Model, build_model
from repro_torch.serving import ServingEngine, configs_from_flags
from repro_torch.serving.checks import assert_decode_matches_teacher_forced


def serve_lockstep(model: Model, params, prompt: torch.Tensor, gen: int, *,
                   vision: Optional[torch.Tensor] = None,
                   frames: Optional[torch.Tensor] = None):
    """Lockstep greedy serving (``repro.launch.serve._serve_lockstep``):
    a decode state for ``prompt``'s B rows and ``prompt_len + gen + 1``
    positions, the cross K/V from ``vision`` (vlm; zeros when None) or
    from the encoder over ``frames`` (encdec; left zero when None), the
    prompt (B, n) decoded token by token, then ``gen`` greedy tokens, each
    the argmax of the last step's logits, kept on the device.  Returns
    ``(tokens (B, gen), logits (B, V), seconds, steps)``: the logits at
    the last prompt position (what the teacher-forced pass gives there),
    the host clock from the first prompt step to the last token on the
    device (synchronized on the card), and the decode steps it ran."""
    cfg = model.cfg
    b, n = prompt.shape
    with torch.no_grad():
        state = model.init_decode_state(b, n + gen + 1)
        if cfg.family == "vlm":
            if vision is None:
                vision = torch.zeros((b, cfg.n_vision_tokens, cfg.d_model),
                                     dtype=cfg.dtype_(), device=model.device)
            state = model.prefill_cross_cache(params, vision, state)
        elif frames is not None:
            memory = encdec.encode(cfg, params, frames)
            state = model.prefill_cross_cache(params, memory, state)
        sync = (torch.cuda.synchronize if model.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            logits, state = model.decode_step(params, state, prompt[:, i])
        prompt_logits = logits
        tok = logits.argmax(dim=-1)
        out = [tok]
        for _ in range(gen - 1):
            logits, state = model.decode_step(params, state, tok)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        sync()
        secs = time.perf_counter() - t0
    return torch.stack(out, dim=1), prompt_logits, secs, n + gen - 1


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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples with per-request keys")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="page-level prompt prefix sharing (needs --layout "
                         "paged): attention families alias pages with "
                         "copy-on-write; recurrent families (ssm/hybrid) "
                         "restore page-boundary state snapshots")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft K tokens per row per "
                         "step and verify them through the chunked prefill "
                         "path (0 = off; needs --prefill-chunk >= 2, "
                         "greedy only)")
    ap.add_argument("--spec-drafter", default="prompt_lookup",
                    choices=["prompt_lookup", "hybrid_ssm"],
                    help="draft source: n-gram prompt lookup (any family) "
                         "or the hybrid family's own Mamba layers")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="prompt-lookup n-gram match length")
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
    if cfg.family in ("encdec", "vlm"):
        return lockstep_main(model, params, prompts, args)

    # a pool below the worst case (--n-pages) preempts into the host tier
    cache, config = configs_from_flags(args)

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
    if "snap_slots" in s:
        print(f"state snapshots: peak {int(s['snap_slots_peak'])} of "
              f"{int(s['snap_slots'])} page-boundary slots")
    if s.get("preemptions"):
        print(f"pressure: {int(s['preemptions'])} preemptions into the host "
              f"tier, {int(s['restores'])} restores")
    if "shared_prompt_tokens" in s:
        print(f"prefix sharing: {int(s['shared_prompt_tokens'])} prompt "
              f"tokens served from shared pages and snapshots "
              f"({int(s['cow_pages'])} CoW copies)")
    if "spec_accept_rate" in s:
        print(f"speculation: {int(s['spec_accepted'])}/"
              f"{int(s['spec_proposed'])} drafts accepted "
              f"({s['spec_accept_rate']:.0%}), "
              f"{int(s['spec_emitted'])} tokens via verify steps")
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


def lockstep_main(model: Model, params, prompts, args) -> int:
    """The CLI for the families without per-row decode state: the first
    ``--batch`` prompts through ``serve_lockstep``."""
    cfg = model.cfg
    if (args.layout != "contiguous" or args.temperature > 0 or args.top_k
            or args.prefix_sharing or args.spec_k or args.prefill_chunk > 1
            or args.kv_dtype != "f32" or args.check or args.profile
            or (args.requests or args.batch) != args.batch):
        print(f"warning: --layout/--kv-dtype/--temperature/--top-k/"
              f"--prefix-sharing/--spec-k/--prefill-chunk/--requests/"
              f"--check/--profile are engine features; the {cfg.family} "
              f"loop is lockstep greedy over the contiguous cache and "
              f"ignores them")
    prompt = torch.as_tensor(prompts[: args.batch], device=model.device)
    toks, _, secs, steps = serve_lockstep(model, params, prompt, args.gen)
    total = args.batch * (args.prompt_len + args.gen)
    print(f"{cfg.name} on {model.device}: lockstep, batch {args.batch}: "
          f"{args.gen} tokens after a {args.prompt_len}-token prompt in "
          f"{secs:.2f} s ({total / secs:.1f} tok/s incl. prefill, "
          f"{1e3 * secs / steps:.2f} ms per step)")
    print("sample:", toks[0, :16].tolist())
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
