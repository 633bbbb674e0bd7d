"""Serving launcher of the port, with random weights made from ``--seed``.

Single-batch (lockstep) mode, the default: ``--batch`` prompts of
``--prompt-len`` random tokens prefill together and decode ``--gen``
tokens in lockstep through the single-batch ``Engine`` (TopK sparse
decode over a contiguous cache; ``--dense`` attends to the whole cache):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 8 --prompt-len 1536 --gen 32

Continuous-batching mode (``--continuous``): Poisson arrivals of random
prompts go through the paged engine (admission queue, chunked prefill,
TopK sparse decode over the physical page pool):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --continuous --requests 8 --prompt-len 1500 --gen 32 --chunk 256

On the CUDA card by default (the kernels build at first use); on the CPU
with ``--device cpu``, where the plain PyTorch versions run:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --reduced --device cpu --batch 2 --prompt-len 32 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --reduced --device cpu --continuous --requests 16 --shared-prefix 4

MoE configs serve their decode-step experts from a paged expert-weight
pool (``--expert-pool paged``: the MoE CUDA kernels on the card) or from
its dense view (``dense``); ``off`` runs the capacity dispatch:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --reduced --device cpu --continuous \
      --expert-pool paged

At full width one card holds 8 of qwen3-moe-235b-a22b's 94 layers:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --layers 8 --continuous \
      --expert-pool paged --requests 8 --prompt-len 1500 --gen 32 \
      --chunk 256

Flags of the reference launcher that belong to later slices of the port
are recognised and rejected with the slice's name.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..params import init_params
from ..serve.engine import KERNELS, Engine, PagedEngine
from ..serve.scheduler import PoissonArrivals

# flag -> the ROADMAP slice that ports it
_LATER_SLICES = {
    "--tp": "6. Tensor parallelism",
    "--runahead": "3. Online runahead staging",
    "--runahead-pages": "3. Online runahead staging",
    "--capture": "3. Online runahead staging",
    "--spill": "4. Host spill tier",
    "--spill-compress": "4. Host spill tier",
    "--executor": "5. Async executor and multi-turn sessions",
    "--workload": "5. Async executor and multi-turn sessions",
    "--session-hold": "5. Async executor and multi-turn sessions",
    "--idle-swap": "5. Async executor and multi-turn sessions",
    "--policy": "5. Async executor and multi-turn sessions",
    # the expert NSB staging tier and its router-keyed runahead
    "--expert-nsb-slots": "3. Online runahead staging",
    "--expert-runahead": "3. Online runahead staging",
    "--expert-runahead-pages": "3. Online runahead staging",
    "--no-donate": "none: PyTorch updates the pools in place",
}


def _fmt(x, spec: str = ".3f") -> str:
    """Format a metric that is None before any traffic."""
    return "n/a" if x is None else format(x, spec)


def build_workload(cfg, args) -> list:
    """``(tick, prompt, max_new)`` arrivals, as the reference launcher
    builds them for its ``--continuous`` mode."""
    rng = np.random.default_rng(args.seed)
    if args.shared_prefix:
        # multi-tenant shape: every request opens with one of a handful
        # of system prompts, so whole prompt pages repeat across requests
        sys_len = max(cfg.kv_page,
                      args.prompt_len // 2 // cfg.kv_page * cfg.kv_page)
        sys_prompts = [rng.integers(1, cfg.vocab, size=sys_len)
                       for _ in range(args.shared_prefix)]
        arrivals = PoissonArrivals(
            args.requests, rate=args.rate,
            prompt_len=(1, max(1, args.prompt_len - sys_len)),
            gen_len=(max(1, args.gen // 2), args.gen), seed=args.seed)
        return [(t, np.concatenate(
            [sys_prompts[i % args.shared_prefix],
             rng.integers(1, cfg.vocab, size=p)]), g)
            for i, (t, p, g) in enumerate(arrivals)]
    arrivals = PoissonArrivals(
        args.requests, rate=args.rate,
        prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
        gen_len=(max(1, args.gen // 2), args.gen), seed=args.seed)
    return [(t, rng.integers(1, cfg.vocab, size=p), g)
            for t, p, g in arrivals]


def run_single_batch(cfg, params, args, device) -> Engine:
    """The reference launcher's default mode: one batch of random
    prompts (drawn from ``--seed`` on the CPU, so the card and the CPU
    see the same tokens) through the single-batch ``Engine``."""
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen)
    eng = Engine(cfg, params, max_len=args.prompt_len + args.gen,
                 sparse=not args.dense, nsb_pages=args.nsb_pages,
                 kernel=args.kernel, device=device)
    out = eng.generate({"tokens": tokens}, args.gen)
    s = eng.stats
    print(f"[serve] generated {out.shape} tokens; sparse={eng.sparse}")
    if eng.sparse and s.hot_hit_rate is not None:
        print(f"[serve] NSB hot-set hit rate {s.hot_hit_rate:.3f} "
              f"(pages touched {s.pages_touched}, unique-miss "
              f"{s.nsb_misses}) -> off-chip fetch reduction "
              f"{100 * s.offchip_reduction:.1f}%")
    return eng


def run(cfg, params, args, device) -> PagedEngine:
    workload = build_workload(cfg, args)
    longest = max(len(p) + g for _, p, g in workload)
    max_len = -(-longest // cfg.kv_page) * cfg.kv_page
    eng = PagedEngine(cfg, params, max_len=max_len, n_pages=args.pages,
                      max_batch=args.max_batch, chunk=args.chunk,
                      nsb_pages=args.nsb_pages,
                      prefix_cache=not args.no_prefix_cache,
                      kernel=args.kernel, device=device,
                      expert_pool=args.expert_pool,
                      expert_tile_rows=args.expert_tile_rows)
    eng.run(workload)
    m = eng.metrics()
    print(f"[serve-cb] {m['n_finished']}/{len(workload)} requests in "
          f"{m['iterations']} iterations ({m['tokens_out']} tokens, "
          f"{m['preemptions']} preemptions, peak "
          f"{m['pages_peak_in_use']}/{eng.allocator.capacity} pages)")
    print(f"[serve-cb] step loop: {m['decode_steps']} decode steps, "
          f"{m['prefill_calls']} prefill chunks ({eng.kernel} kernel on "
          f"{eng.device}), {m['decode_rows_padded']} padded decode rows")
    print(f"[serve-cb] latency p50/p99 {_fmt(m['p50_latency'], '.0f')}/"
          f"{_fmt(m['p99_latency'], '.0f')} iters; TTFT p50/p99 "
          f"{_fmt(m['p50_ttft'], '.0f')}/{_fmt(m['p99_ttft'], '.0f')}; "
          f"TPOT p50/p99 {_fmt(m['p50_tpot'], '.2f')}/"
          f"{_fmt(m['p99_tpot'], '.2f')}")
    print(f"[serve-cb] NSB hot-set hit rate "
          f"{_fmt(m['nsb_hot_hit_rate'])}")
    if not args.no_prefix_cache:
        print(f"[serve-cb] prefix cache: {m['prefix_hit_pages']} page "
              f"hits, {m['prefill_tokens_skipped']} prompt tokens "
              f"skipped ({m['prefill_tokens_run']} run), "
              f"{m['cow_copies']} COW copies, "
              f"{m['prefix_evictions']} evictions")
    if args.expert_pool != "off":
        print(f"[serve-cb] expert pool={m['expert_pool']}: "
              f"{m['expert_pool_pages']} tile pages "
              f"({m['expert_pool_mib']:.2f} MiB, "
              f"{m['expert_tile_rows']}-row tiles), "
              f"{m['expert_pages_touched']} demand touches, hit rate "
              f"{_fmt(m['expert_nsb_hit_rate'])} (demand-LRU baseline "
              f"{_fmt(m['expert_demand_lru_hit_rate'])})")
    return eng


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--layers", type=int, default=0, metavar="N",
                   help="cut the config to N layers (depth only; one card "
                        "holds 8 layers of qwen3-moe-235b-a22b's experts)")
    p.add_argument("--batch", type=int, default=4,
                   help="prompts of the single-batch mode")
    p.add_argument("--dense", action="store_true",
                   help="single-batch mode: dense decode attention over "
                        "the whole cache instead of TopK pages")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching on the paged KV allocator "
                        "(the PagedEngine) instead of one lockstep batch")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=0.5,
                   help="Poisson arrivals per scheduler iteration")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--pages", type=int, default=0,
                   help="physical KV pages (0 = worst-case sized)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16,
                   help="prefill chunk tokens per iteration")
    p.add_argument("--nsb-pages", type=int, default=64)
    p.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                   help="draw prompts over N shared system prompts")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable cross-request COW prefix caching")
    p.add_argument("--kernel", choices=KERNELS, default="cuda",
                   help="attention: cuda = the port's kernels (plain "
                        "versions for CPU tensors); torch = the plain "
                        "versions everywhere")
    p.add_argument("--expert-pool", choices=("off", "dense", "paged"),
                   default="off",
                   help="MoE decode experts: off = capacity dispatch; "
                        "dense = routed experts' rows from a dense view; "
                        "paged = row-tile pages through the block table")
    p.add_argument("--expert-tile-rows", type=int, default=32,
                   help="rows of d_ff per expert weight tile page")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and the workload")
    for flag in _LATER_SLICES:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, slice_name in _LATER_SLICES.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{flag} is not ported yet (ROADMAP slice: "
                    f"{slice_name})")
    if args.expert_pool != "off" and not args.continuous:
        p.error("--expert-pool needs --continuous (the single-batch "
                "Engine runs the capacity dispatch)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    if args.continuous:
        return run(cfg, params, args, device)
    return run_single_batch(cfg, params, args, device)


if __name__ == "__main__":
    main()
