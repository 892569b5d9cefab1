"""serve-bench: drive the serving engine, or a routed fleet of engine
replicas, under offered load and report serving metrics.

Counterpart of ``accelerate_tpu/commands/serve_bench.py``, run as ``python
-m accelerate_tpu_torch.commands.serve_bench [flags]`` or
``accelerate-tpu-torch serve-bench [flags]``. A seeded prompt
trace replays against a :class:`~..serving.ServingEngine`, or with
``--replicas N`` a :class:`~..serving.ServingRouter` over N replicas of one
model, at each ``--offered-load`` rate and then at saturation (everything
at once); each point reports throughput, TTFT and per-token percentiles and
slot occupancy.

- ``--chaos replica-kill|replica-stall|heartbeat-loss`` drills the fleet at
  the saturation point; ``--prefill-replicas N --decode-replicas M`` splits
  it into disaggregated pools with the live KV handoff, and
  ``--chaos handoff-stall|handoff-loss|prefill-kill`` drills that. The
  drill line says whether every offered request terminated exactly once.
- ``--trace-load burst|diurnal`` replays a Poisson arrival trace, and
  ``--autoscale`` replays it against the fixed fleet and one with a
  :class:`~..serving.RoleRebalancer`, comparing sheds and TTFT p99.
- ``--trace`` traces every request, evaluates the SLO burn rates at the
  last retirement and writes ``trace.json`` (Chrome/Perfetto trace events)
  into ``--trace-dir``, beside the telemetry hub's ``telemetry.jsonl`` (the
  engines' and the router's records, the traces and the SLO evaluations).

``--device`` picks the card (the default, CUDA) or ``cpu``; in bf16 on the
card, fp32 on the CPU. The JSON payload keeps the JAX payload's keys where
they mean the same. The JAX version's compile attribution (the warm-up and
steady-state compile counts, ``kernels`` from ``kernel_summary``) has no
counterpart in this eager port and is left out. Instead ``kernel_launches``
gives each serving kernel wrapper's launches after the warm-up (all zero on
the CPU, where the wrappers run their plain versions), and ``forwards`` the
target-model forwards by kind of every engine measured, so that a caller can
hold the launches against layers x forwards. ``--no-kernels`` exists only so
that the flag set matches the JAX version's: it is refused, since a CUDA
tensor always launches the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.serve_bench",
        description="Benchmark the continuous-batching serving engine",
    )
    parser.add_argument("--model", default="llama-125m", help="Registry model name")
    parser.add_argument("--num-slots", type=int, default=8, help="Concurrent decode slots")
    parser.add_argument("--max-len", type=int, default=512, help="Per-slot KV capacity (tokens)")
    parser.add_argument("--requests", type=int, default=32, help="Requests per sweep point")
    parser.add_argument("--max-new-tokens", type=int, default=64)
    parser.add_argument("--prompt-len-min", type=int, default=16)
    parser.add_argument("--prompt-len-max", type=int, default=192)
    parser.add_argument("--offered-load", type=float, nargs="*", default=[],
                        help="Offered rates (req/s) to sweep before the saturation point")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Engine replicas behind a health-aware router (1 = bare engine)")
    parser.add_argument("--prefill-replicas", type=int, default=0,
                        help="Disaggregated serving: replicas in the prefill pool (with "
                             "--decode-replicas; overrides --replicas)")
    parser.add_argument("--decode-replicas", type=int, default=0,
                        help="Disaggregated serving: replicas in the decode pool (prompts "
                             "prefill on the prefill pool, the live KV is handed off here)")
    parser.add_argument("--chaos", default=None,
                        choices=["replica-kill", "replica-stall", "heartbeat-loss",
                                 "handoff-stall", "handoff-loss", "prefill-kill"],
                        help="Fleet fault to inject at the saturation point (replica faults need "
                             ">= 2 replicas; handoff-*/prefill-kill need the two pools)")
    parser.add_argument("--chaos-step", type=int, default=None,
                        help="Fleet step the fault fires at (default: max-new-tokens // 2); for "
                             "handoff-stall/handoff-loss the handoff attempt index (default 0)")
    parser.add_argument("--autoscale", action="store_true",
                        help="Replay the --trace-load trace against the fixed fleet and one with a "
                             "RoleRebalancer attached; needs the two pools and --trace-load")
    parser.add_argument("--trace-load", choices=("burst", "diurnal"), default=None,
                        help="A Poisson arrival trace: 'burst' is a 4x flash crowd mid-trace, "
                             "'diurnal' a sinusoidal rate swing")
    parser.add_argument("--trace-load-rps", type=float, default=8.0,
                        help="Base request rate (req/s) for --trace-load arrivals")
    parser.add_argument("--mixed", action="store_true",
                        help="Mostly-short prompts with a long tail (--long-fraction at "
                             "--long-multiplier x the median length)")
    parser.add_argument("--long-fraction", type=float, default=0.1,
                        help="Fraction of prompts in the long tail (with --mixed)")
    parser.add_argument("--long-multiplier", type=int, default=8,
                        help="Long prompts span long-multiplier..2 x long-multiplier x the median "
                             "short length (with --mixed)")
    parser.add_argument("--shared-prefix", type=int, default=0,
                        help="Prepend a common N-token system prompt to every request")
    parser.add_argument("--page-size", type=int, default=16, help="Tokens per KV page")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="Split long prompts into chunks of this many tokens (a multiple of "
                             "--page-size)")
    parser.add_argument("--no-paged", action="store_true",
                        help="Serve from the dense per-slot slab instead of the paged pool")
    parser.add_argument("--no-kernels", action="store_true",
                        help="Only matches the JAX version's flags, and is refused: a CUDA tensor "
                             "always launches the kernels, and CPU tensors take their plain versions")
    parser.add_argument("--trace", action="store_true",
                        help="Trace every request, evaluate the SLO burn rates and write "
                             "trace.json (Perfetto trace events)")
    parser.add_argument("--trace-dir", default=".", help="Directory for trace.json (with --trace)")
    parser.add_argument("--slo-ttft-s", type=float, default=60.0,
                        help="TTFT objective (with --trace): 99%% of requests see a first token "
                             "within this many seconds")
    parser.add_argument("--slo-window-s", type=float, default=3600.0,
                        help="SLO rolling-window width in seconds (with --trace)")
    parser.add_argument("--speculative", action="store_true",
                        help="Draft-model speculative decoding (temperature 0, paged)")
    parser.add_argument("--draft-model", default=None,
                        help="Registry name of the draft model (the target's vocabulary). "
                             "Default: the target's architecture at half depth")
    parser.add_argument("--spec-k", type=int, default=4, help="Draft tokens proposed a step")
    parser.add_argument("--spec-mode", choices=("linear", "tree"), default="linear")
    parser.add_argument("--spec-branches", type=int, default=2, help="Tree-mode branch count")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--eos-token-id", type=int, default=None)
    parser.add_argument("--int8", action="store_true", help="int8 weight-only load path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", action="store_true", help="One JSON object instead of a table")
    parser.add_argument("--device", default=None,
                        help="'cuda' (the default) or 'cpu'; without a card the default raises")
    return parser


def _kernel_launches() -> dict:
    """Each serving kernel wrapper's launch count."""
    from ..ops.paged_attention import paged_decode_attention, paged_verify_attention
    from ..ops.quant_matmul import quant_matmul

    return {"paged_decode": paged_decode_attention.launches,
            "paged_verify": paged_verify_attention.launches,
            "quant_matmul": quant_matmul.launches}


def run(args) -> int:
    import torch

    from ..models import build_model
    from ..ops.runtime import resolve_device
    from ..serving import (
        ServingEngine,
        ServingRouter,
        make_mixed_prompts,
        make_prompts,
        params_from_streamed,
        quantized_resident_params,
        run_offered_load,
    )

    disagg = args.prefill_replicas > 0 or args.decode_replicas > 0
    if disagg and (args.prefill_replicas < 1 or args.decode_replicas < 1):
        print("disaggregation needs BOTH --prefill-replicas >= 1 and --decode-replicas >= 1")
        return 1
    roles = ["prefill"] * args.prefill_replicas + ["decode"] * args.decode_replicas if disagg else None
    n_replicas = len(roles) if disagg else args.replicas
    if args.chaos in ("handoff-stall", "handoff-loss", "prefill-kill") and not disagg:
        print(f"--chaos {args.chaos} drills the prefill/decode split — set "
              "--prefill-replicas and --decode-replicas")
        return 1
    if args.chaos is not None and n_replicas < 2:
        print(f"--chaos {args.chaos} needs >= 2 replicas (a 1-replica fleet has no failover)")
        return 1
    if disagg and args.no_paged:
        print("disaggregated serving relays page-granular KV — drop --no-paged")
        return 1
    if args.autoscale and not disagg:
        print("--autoscale rebalances between pools — set --prefill-replicas and --decode-replicas")
        return 1
    if args.autoscale and args.trace_load is None:
        print("--autoscale drills against an arrival trace — add --trace-load burst|diurnal")
        return 1
    if args.no_kernels:
        print("--no-kernels: the port has no kernel-free path on the card (a CUDA tensor launches "
              "the kernels; on --device cpu the plain versions run anyway)")
        return 1
    if args.speculative and args.no_paged:
        print("--speculative verifies against the paged pool — drop --no-paged")
        return 1
    if args.speculative and args.temperature != 0.0:
        print("--speculative is temperature-0 only (greedy verify)")
        return 1

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = build_model(args.model, seed=args.seed, dtype=dtype, device=device)

    spec_cfg = None
    if args.speculative:
        from ..serving import SpeculativeConfig

        if args.draft_model:
            draft = build_model(args.draft_model, seed=args.seed + 1, dtype=dtype, device=device)
            if draft.config.vocab_size != model.config.vocab_size:
                print(f"--draft-model {args.draft_model} has vocab {draft.config.vocab_size}, target "
                      f"has {model.config.vocab_size} — drafts must share the target's vocabulary")
                return 1
        else:
            # the target's own architecture at half depth
            draft = type(model)(
                model.config.replace(num_layers=max(1, model.config.num_layers // 2)),
                device=device, dtype=dtype, seed=args.seed + 1,
            )
        spec_cfg = SpeculativeConfig(draft_model=draft, k=args.spec_k, mode=args.spec_mode,
                                     num_branches=args.spec_branches)
    if args.int8:
        from ..big_modeling import dispatch_model, make_layered_device_map
        from ..utils.quantization import QuantizationConfig

        streamed = dispatch_model(
            model, device_map=make_layered_device_map(model, "cpu"), dtype=dtype,
            quantization=QuantizationConfig(load_in_8bit=True), device=device,
        )
        # the matrices stay packed on the device behind the dequant-matmul;
        # installed once, so every engine below serves the same weights
        params = quantized_resident_params(streamed)
        streamed.model.install(params if params is not None else params_from_streamed(streamed))
        model = streamed.model

    if args.mixed or args.shared_prefix:
        prompts = make_mixed_prompts(
            args.requests, model.config.vocab_size, args.prompt_len_min, args.prompt_len_max,
            long_fraction=args.long_fraction if args.mixed else 0.0,
            long_multiplier=args.long_multiplier, shared_prefix=args.shared_prefix, seed=args.seed,
        )
    else:
        prompts = make_prompts(args.requests, model.config.vocab_size, args.prompt_len_min,
                               args.prompt_len_max, seed=args.seed)
    longest = max(p.size for p in prompts)
    max_len = max(args.max_len, longest + args.max_new_tokens)
    if max_len > args.max_len:
        print(f"note: --max-len raised {args.max_len} -> {max_len} to fit the longest prompt "
              f"({longest} tokens) + max_new_tokens")

    # one tracer and one hub shared by every sweep point's engines and
    # fleets, so telemetry.jsonl and the Perfetto export cover the whole run,
    # drill included
    hub = tracer = slo = None
    if args.trace:
        from ..telemetry import RequestTracer, SLOMonitor, Telemetry, TelemetryConfig, default_objectives

        hub = Telemetry(config=TelemetryConfig(dir=args.trace_dir))
        slo = SLOMonitor(default_objectives(ttft_s=args.slo_ttft_s, window_s=args.slo_window_s), telemetry=hub)
        tracer = RequestTracer(telemetry=hub, slo=slo)

    engines = []  # every engine built, for the forward counts

    def fresh_engine():
        # every engine serves the one model: replicas and sweep points hold
        # one copy of the weights and a KV pool each
        engine = ServingEngine(
            model, num_slots=args.num_slots, max_len=max_len, eos_token_id=args.eos_token_id,
            temperature=args.temperature, paged=not args.no_paged, page_size=args.page_size,
            prefill_chunk=args.prefill_chunk, tracer=tracer, speculative=spec_cfg, device=device,
        )
        engine.telemetry = hub
        engines.append(engine)
        return engine

    def fresh_target(fault_plan=None, autoscale=None):
        if n_replicas == 1 and not disagg:
            return fresh_engine()
        kwargs = {}
        if args.chaos == "handoff-stall" and fault_plan is not None:
            # the stalled transfer must overshoot the timeout, or the attempt
            # adopts late and the drill tests nothing
            kwargs["handoff_timeout_s"] = fault_plan.stall_seconds / 2.0
        return ServingRouter(
            engine_factory=fresh_engine, num_replicas=n_replicas, roles=roles,
            fault_plan=fault_plan, tracer=tracer, telemetry=hub, autoscale=autoscale, **kwargs,
        )

    def fleet_fault_plan():
        from ..resilience import FaultPlan

        step = args.chaos_step if args.chaos_step is not None else args.max_new_tokens // 2
        attempt = args.chaos_step if args.chaos_step is not None else 0
        kwargs = {
            "replica-kill": {"replica_kill_step": step, "replica_kill_index": n_replicas - 1},
            "replica-stall": {"replica_stall_step": step, "replica_stall_index": n_replicas - 1},
            "heartbeat-loss": {"heartbeat_loss_step": step, "heartbeat_loss_index": n_replicas - 1},
            # replica 0 is always in the prefill pool, where KV parks
            "prefill-kill": {"replica_kill_step": step, "replica_kill_index": 0},
            "handoff-stall": {"handoff_stall_at": (attempt,)},
            "handoff-loss": {"handoff_loss_at": (attempt,)},
        }[args.chaos]
        return FaultPlan(seed=args.seed, **kwargs)

    # warm-up: one synthetic request per prefill bucket and the decode step
    # build the kernels before any point is measured
    fresh_target().warmup()
    engines.clear()
    launches_before = _kernel_launches()
    points = [run_offered_load(fresh_target(), prompts, args.max_new_tokens, offered_rps=rate)
              for rate in args.offered_load]
    points.append(run_offered_load(fresh_target(), prompts, args.max_new_tokens, math.inf))

    autoscale_drill = None
    trace_point = None
    if args.trace_load is not None:
        from ..serving import make_burst_trace, make_diurnal_trace

        maker = make_burst_trace if args.trace_load == "burst" else make_diurnal_trace
        arrivals = maker(args.requests, args.trace_load_rps, seed=args.seed)
        trace_point = run_offered_load(fresh_target(), prompts, args.max_new_tokens, arrival_times=arrivals)
        if args.autoscale:
            from ..serving import AutoscalePolicy, RoleRebalancer

            # hysteresis at fleet-step scale: the trace lasts seconds
            rebalancer = RoleRebalancer(
                policy=AutoscalePolicy(cadence_steps=2, min_dwell_steps=8, cooldown_steps=20)
            )
            rebalanced = run_offered_load(fresh_target(autoscale=rebalancer), prompts,
                                          args.max_new_tokens, arrival_times=arrivals)
            autoscale_drill = {
                "trace": args.trace_load,
                "base_rps": args.trace_load_rps,
                "fixed_sheds": trace_point["loadgen_sheds"],
                "rebalanced_sheds": rebalanced["loadgen_sheds"],
                "fixed_ttft_p99_ms": trace_point["loadgen_ttft_p99_ms"],
                "rebalanced_ttft_p99_ms": rebalanced["loadgen_ttft_p99_ms"],
                "fixed_completed": trace_point["requests_completed"],
                "rebalanced_completed": rebalanced["requests_completed"],
                "flip_count": rebalanced["autoscale_flip_count"],
                "thrash_count": rebalanced["autoscale_thrash_count"],
                "aborted_flips": rebalanced["autoscale_aborted_flips"],
                "fail_static_count": rebalanced["autoscale_fail_static_count"],
            }

    drill = None
    # traces_completed is monotonic (the ring it feeds is bounded): the
    # drill's traces are the last ones completed after this mark
    drill_trace_mark = tracer.traces_completed if tracer is not None else 0
    if args.chaos is not None:
        target = fresh_target(fault_plan=fleet_fault_plan())
        drill = run_offered_load(target, prompts, args.max_new_tokens, math.inf)
        healthy = points[-1]
        drill.update({
            "chaos": args.chaos,
            "replica_deaths": target.replica_deaths,
            "failovers": target.failovers,
            "kv_handoffs": getattr(target, "kv_handoffs", 0),
            # every offered request must terminate: the loadgen's count
            "accounted": drill["requests_completed"],
            "goodput_retained": (
                drill["throughput_tokens_per_sec"] / healthy["throughput_tokens_per_sec"]
                if healthy["throughput_tokens_per_sec"] else None
            ),
        })

    trace_path = None
    slo_records = []
    slowest_drill_trace = None
    if tracer is not None:
        from ..telemetry import to_perfetto

        # evaluated at the last retirement, so export time ages nothing out
        records = list(tracer.completed)
        last_stamp = max((r["t1"] for r in records), default=None)
        slo_records = slo.evaluate(stamp=last_stamp)
        os.makedirs(args.trace_dir, exist_ok=True)
        trace_path = os.path.join(args.trace_dir, "trace.json")
        with open(trace_path, "w") as f:
            json.dump(to_perfetto(records), f)
        if drill is not None:
            n_drill = min(tracer.traces_completed - drill_trace_mark, len(records))
            drill_traces = records[-n_drill:] if n_drill > 0 else []
            if drill_traces:
                slowest_drill_trace = max(drill_traces, key=lambda r: r.get("latency_s") or 0.0)

    launches_after = _kernel_launches()
    payload = {
        "model": args.model,
        "device": str(device),
        "num_slots": args.num_slots,
        "max_len": max_len,
        "requests": args.requests,
        "max_new_tokens": args.max_new_tokens,
        "replicas": n_replicas,
        "prefill_replicas": args.prefill_replicas if disagg else None,
        "decode_replicas": args.decode_replicas if disagg else None,
        "int8": bool(args.int8),
        "kernel_launches": {k: launches_after[k] - launches_before[k] for k in launches_after},
        "forwards": {k: sum(e.forward_counts[k] for e in engines) for k in ("prefill", "decode", "verify")},
        "paged": not args.no_paged,
        "page_size": args.page_size if not args.no_paged else None,
        "prefill_chunk": args.prefill_chunk,
        "speculative": (
            {"k": args.spec_k, "mode": args.spec_mode, "draft_model": args.draft_model or "auto-half-depth"}
            if spec_cfg is not None else None
        ),
        "mixed": bool(args.mixed),
        "shared_prefix": args.shared_prefix,
        "sweep": points,
    }
    if trace_point is not None:
        payload["load_trace"] = {"kind": args.trace_load, "base_rps": args.trace_load_rps, "point": trace_point}
    if autoscale_drill is not None:
        payload["autoscale_drill"] = autoscale_drill
    if tracer is not None:
        payload["trace"] = {
            "traces_completed": tracer.traces_completed,
            "traces_open": tracer.open_count,  # 0 after the drain
            "perfetto_path": trace_path,
            "slo": slo_records,
        }
    if drill is not None:
        payload["chaos_drill"] = drill
        if slowest_drill_trace is not None:
            from ..telemetry import trace_summary

            payload["chaos_drill"]["slowest_trace"] = trace_summary(slowest_drill_trace)
    if args.json:
        print(json.dumps(payload))
        return 0
    _print_table(args, payload, points, trace_point, autoscale_drill, drill, tracer, slo_records,
                 trace_path, disagg, n_replicas, max_len, spec_cfg)
    return 0


def _print_table(args, payload, points, trace_point, autoscale_drill, drill, tracer, slo_records,
                 trace_path, disagg, n_replicas, max_len, spec_cfg) -> None:
    if disagg:
        fleet = f", {args.prefill_replicas} prefill + {args.decode_replicas} decode replicas"
    elif n_replicas > 1:
        fleet = f", {n_replicas} replicas"
    else:
        fleet = ""
    layout = (
        f"paged(page_size={args.page_size}" + (f", chunk={args.prefill_chunk}" if args.prefill_chunk else "") + ")"
        if not args.no_paged else "dense slots"
    )
    scenario = (", mixed long/short" if args.mixed else "") + (
        f", shared prefix {args.shared_prefix}" if args.shared_prefix else "")
    print(f"serve-bench {args.model} on {payload['device']}: {args.num_slots} slots × {max_len} tokens "
          f"[{layout}]{fleet}, {args.requests} requests, max_new={args.max_new_tokens}{scenario}"
          + (", int8 weights" if args.int8 else ""))
    print(f"kernel launches: {payload['kernel_launches']}, target forwards: {payload['forwards']}")
    if spec_cfg is not None:
        sat = points[-1]
        proposed = sat.get("spec_proposed_tokens", 0)
        accepted = sat.get("spec_accepted_tokens", 0)
        rate = accepted / proposed if proposed else 0.0
        print(f"speculative: mode={args.spec_mode} k={args.spec_k} draft={payload['speculative']['draft_model']} "
              f"— {accepted}/{proposed} draft tokens accepted ({rate:.0%}), accepted-len p50 "
              f"{sat.get('spec_accepted_len_p50', 0.0)} / p99 {sat.get('spec_accepted_len_p99', 0.0)}, "
              f"{sat.get('spec_fallbacks', 0)} fallbacks")
    header = (f"{'offered req/s':>14} | {'tok/s':>9} | {'ttft p50':>9} | {'ttft p99':>9} | "
              f"{'tok p50':>8} | {'tok p99':>8} | {'occupancy':>9}")
    print(header)
    print("-" * len(header))
    for point in points:
        rate = "saturate" if point["offered_rps"] is None else f"{point['offered_rps']:g}"
        print(f"{rate:>14} | {point['throughput_tokens_per_sec']:>9.1f} | "
              f"{point.get('ttft_p50_ms', 0):>7.1f}ms | {point.get('ttft_p99_ms', 0):>7.1f}ms | "
              f"{point.get('per_token_p50_ms', 0):>6.1f}ms | {point.get('per_token_p99_ms', 0):>6.1f}ms | "
              f"{point['slot_occupancy']:>9.2f}")
    sat = points[-1]
    if not args.no_paged and "page_occupancy" in sat:
        print(f"page economy (saturation): occupancy {sat['page_occupancy']:.2f}, peak "
              f"{sat['peak_pages_in_use']}/{sat['num_pages'] - 1} pages, prefix hit rate "
              f"{sat.get('prefix_hit_rate', 0.0):.2f} ({sat.get('prefix_tokens_reused', 0)} tokens reused), "
              f"{sat.get('prefill_chunks', 0)} prefill chunks, {sat.get('cow_page_copies', 0)} COW copies")
    if disagg:
        print(f"handoff economy (saturation): {sat.get('handoffs_adopted', 0)} adopted / "
              f"{sat.get('handoffs_retried', 0)} retried / {sat.get('handoff_fallbacks', 0)} fell back to "
              f"re-prefill, {sat.get('handoff_pages_moved', 0)} pages "
              f"({sat.get('handoff_bytes_moved', 0) / 1e6:.1f} MB) moved, handoff p50 "
              f"{sat.get('handoff_p50_ms', 0):.1f}ms / p99 {sat.get('handoff_p99_ms', 0):.1f}ms")
    if trace_point is not None:
        print(f"load trace ({args.trace_load} @ {args.trace_load_rps:g} req/s base): "
              f"{trace_point['loadgen_sheds']} sheds, ttft p50 {trace_point['loadgen_ttft_p50_ms'] or 0:.1f}ms / "
              f"p99 {trace_point['loadgen_ttft_p99_ms'] or 0:.1f}ms, "
              f"{trace_point['requests_completed']}/{trace_point['offered_requests']} completed")
    if autoscale_drill is not None:
        a = autoscale_drill
        print(f"autoscale drill: sheds {a['fixed_sheds']} fixed -> {a['rebalanced_sheds']} rebalanced, "
              f"ttft p99 {a['fixed_ttft_p99_ms'] or 0:.1f}ms -> {a['rebalanced_ttft_p99_ms'] or 0:.1f}ms, "
              f"{a['flip_count']} flip(s), {a['thrash_count']} thrash (must be 0), {a['aborted_flips']} aborted")
    if drill is not None:
        retained = drill["goodput_retained"]
        print(f"chaos drill ({drill['chaos']}): {drill['requests_completed']}/{drill['offered_requests']} "
              f"requests terminated exactly once, {drill['replica_deaths']} replica death(s), "
              f"{drill['failovers']} failover(s), "
              + (f"{drill.get('handoffs_adopted', 0)} handoff(s) adopted, "
                 f"{drill.get('handoff_fallbacks', 0)} fell back to re-prefill, " if disagg else "")
              + "goodput retained " + (f"{retained:.2f}x vs healthy" if retained is not None else "n/a"))
        if "slowest_trace" in drill:
            print(f"slowest drill trace: {drill['slowest_trace']}")
    if tracer is not None:
        for record in slo_records:
            burn = record["burn_rate"]
            print(f"slo {record['objective']}: burn rate " + (f"{burn:.2f}" if burn is not None else "n/a (no data)")
                  + f" of budget {record['budget']:.3f}" + (" — BREACHED" if record["breached"] else "")
                  + f" ({record['window_bad']}/{record['window_observed']} bad in window)")
        print(f"traces: {tracer.traces_completed} completed, {tracer.open_count} open (must be 0) — "
              f"Perfetto JSON at {trace_path} (open in https://ui.perfetto.dev)")


def register_subcommand(subparsers):
    """``serve-bench`` under ``accelerate-tpu-torch``, with this module's flags."""
    parser = subparsers.add_parser("serve-bench", parents=[build_parser()], add_help=False,
                                   help="Benchmark the serving engine under offered load")
    parser.set_defaults(func=run)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
