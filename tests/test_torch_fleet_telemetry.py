"""The port's request tracing, SLO burn rates, offered load, pool autoscaling
and serve-bench (accelerate_tpu_torch/telemetry/tracing.py, slo.py, the
engine's spans, serving/loadgen.py, serving/autoscale.py,
commands/serve_bench.py) against the JAX package's, on the CPU in fp32 with
``llama-tiny`` and the JAX package's weights.

The traced scenarios run once per module on each package (the ``runs``
fixture caches both). Span trees must be equal in span kinds, names, order,
replica names and attributes; times are left out (``t0``, ``t1``,
``dur_s``, each decode mark's stamp, the trace's latency and TTFT), and so
is the trace id, a process-wide sequence. SLO math, loadgen traces and the
rebalancer's decisions run on scripted inputs and must be equal exactly;
the autoscale records leave out the wall-clock ``seconds`` and ``stamp``.
The scenarios follow ``tests/test_tracing.py``, ``tests/test_loadgen.py``
and ``tests/test_autoscale.py``."""

import json
import math

import numpy as np
import pytest

import accelerate_tpu.serving as jax_serving
import accelerate_tpu.telemetry as jax_telemetry
import accelerate_tpu.telemetry.serving as jax_telemetry_serving
import accelerate_tpu_torch.serving as port_serving
import accelerate_tpu_torch.telemetry as port_telemetry
import accelerate_tpu_torch.telemetry.serving as port_telemetry_serving
from torch_shared import MODEL, Recorder, once, one_cpu_thread, scenario_runs  # noqa: F401 - a module fixture
from torch_shared import prompts as _prompts
from torch_shared import router as _router
from torch_shared import sides as _sides
from torch_shared import step_all as _step_all

TIMES = ("t0", "t1", "dur_s")
# the wall-clock fields of the autoscale records
AUTOSCALE_TIMES = ("seconds", "stamp", "t0")


@pytest.fixture(scope="module")
def sides():
    return _sides()


def _tree(record):
    """A trace record without its times and trace id."""
    spans = []
    for span in record["spans"]:
        span = {k: v for k, v in span.items() if k not in TIMES}
        if "marks" in span:
            span["marks"] = [m["step"] for m in span["marks"]]
        spans.append(span)
    meta = {k: v for k, v in record.items() if k not in TIMES + ("spans", "trace_id", "latency_s", "ttft_s")}
    return {**meta, "has_ttft": record["ttft_s"] is not None, "spans": spans}


def _traced(tracer):
    by_id = {}
    for record in tracer.completed:
        assert record["request_id"] not in by_id, "a request owns two span trees"
        by_id[record["request_id"]] = record
    return by_id


def _tracer(side, **kw):
    slo = side.telemetry.SLOMonitor(side.telemetry.default_objectives(ttft_s=60.0))
    return side.telemetry.RequestTracer(sample_every=2, slo=slo, **kw), slo


# -- the traced scenarios ---------------------------------------------------------


def scenario_traced_disagg(side):
    """Disaggregated pools, chunked prefill, sampled decode marks."""
    tracer, slo = _tracer(side)
    router = _router(side, roles=["prefill", "decode", "decode"], tracer=tracer,
                     engine={"page_size": 8, "prefill_chunk": 8})
    ids = [router.submit(p, max_new_tokens=6) for p in _prompts([3, 20, 12, 5, 30], seed=3)]
    results = _step_all(router)
    m = router.metrics()
    return {"ids": ids, "records": _traced(tracer), "open": tracer.open_count,
            "reasons": {r.request_id: r.finish_reason for r in results},
            "tokens": {r.request_id: np.asarray(r.generated).tolist() for r in results},
            "slo": slo.snapshot(), "counters": {k: m[k] for k in (
                "traces_completed", "trace_spans", "slo_good_events", "slo_bad_events")},
            "span_keys": sorted(k for k in m if k.startswith("span_"))}


def scenario_traced_kill(side):
    """A replica killed mid-decode: its requests' spans are interrupted and
    reopen on the survivor."""
    tracer, slo = _tracer(side)
    plan = side.resilience.FaultPlan(replica_kill_step=3, replica_kill_index=0)
    router = _router(side, tracer=tracer, fault_plan=plan)
    ids = [router.submit(p, max_new_tokens=6) for p in _prompts([3, 7, 12, 5, 9, 4], seed=1)]
    _step_all(router)
    return {"ids": ids, "records": _traced(tracer), "open": tracer.open_count, "slo": slo.snapshot()}


def scenario_traced_handoff_loss(side):
    """One request whose first handoff attempt is lost: retried, adopted."""
    tracer, _ = _tracer(side)
    plan = side.resilience.FaultPlan(handoff_loss_at=(0,))
    router = _router(side, roles=["prefill", "decode"], tracer=tracer, fault_plan=plan)
    ids = [router.submit(_prompts([9], seed=4)[0], max_new_tokens=4)]
    _step_all(router)
    return {"ids": ids, "records": _traced(tracer), "open": tracer.open_count}


def _spec_scenario(side, mode):
    tracer, _ = _tracer(side)
    engine = side.engine(num_slots=2, max_len=64, page_size=8, tracer=tracer,
                         speculative=side.spec(k=3, mode=mode, num_branches=2))
    ids = [engine.submit(p, max_new_tokens=8) for p in _prompts([5, 11, 7], seed=6)]
    results = engine.run()
    return {"ids": ids, "records": _traced(tracer), "open": tracer.open_count,
            "tokens": {rid: r.generated.tolist() for rid, r in results.items()}}


def scenario_traced_spec_linear(side):
    return _spec_scenario(side, "linear")


def scenario_traced_spec_tree(side):
    return _spec_scenario(side, "tree")


def scenario_offered_load(side):
    """``run_offered_load`` through a router: all at once, then a burst
    trace fast enough that no arrival waits on the clock for long."""
    out = {}
    prompts = _prompts([4, 9, 6, 12, 3, 8], seed=11)
    for name, kwargs in (("saturate", {"offered_rps": math.inf}),
                         ("burst", {"arrival_times": side.serving.make_burst_trace(6, 400.0, seed=2)}),
                         ("uniform", {"offered_rps": 500.0})):
        point = side.serving.run_offered_load(_router(side), prompts, 5, **kwargs)
        out[name] = {k: point[k] for k in (
            "offered_rps", "offered_requests", "requests_completed", "loadgen_sheds", "loadgen_retries",
            "loadgen_finish_reasons", "tokens_generated", "requests_submitted", "replicas")}
        out[name]["has_ttft"] = point["loadgen_ttft_p99_ms"] is not None
    shedding = _router(side, engine={"num_slots": 1, "max_queue": 1})
    point = side.serving.run_offered_load(shedding, prompts, 4, offered_rps=math.inf)
    out["shedding"] = {k: point[k] for k in ("offered_requests", "requests_completed", "loadgen_finish_reasons")}
    out["shedding"]["balanced"] = point["loadgen_sheds"] == point["loadgen_retries"] > 0
    return out


def _script(step):
    """The scripted signals of one fleet step: starvation, an outage, a
    stale rollup, the reverse starvation, then an oscillation."""
    pools = {"prefill": {"replicas": 1, "pressure": 5.0, "slots": 2},
             "decode": {"replicas": 2, "pressure": 0.0, "slots": 4}}
    if step < 10:
        return {"fleet_step": step, "pools": pools}
    if step < 13:
        raise RuntimeError("telemetry store unreachable")
    if step < 16:
        return {"fleet_step": 0, "pools": pools}
    if step < 30:
        return {"fleet_step": step, "pools": {
            "prefill": {"replicas": 2, "pressure": 0.0, "slots": 4},
            "decode": {"replicas": 1, "pressure": 5.0, "slots": 2, "sheds": step}}}
    return {"fleet_step": step, "pools": {
        "prefill": {"replicas": 2, "pressure": 5.0 if step % 2 else 0.0, "slots": 4},
        "decode": {"replicas": 1, "pressure": 1.0, "slots": 2}}}


def scenario_rebalancer(side):
    """The rebalancer on the scripted signals, step by step: its flips,
    holds and fail-static decisions."""
    sink = Recorder()
    tracer, _ = _tracer(side)
    reb = side.serving.RoleRebalancer(
        policy=side.serving.AutoscalePolicy(cadence_steps=1, min_dwell_steps=4, cooldown_steps=2,
                                            stale_after_steps=3),
        signal_reader=lambda router: _script(router._steps),
    )
    router = _router(side, roles=["prefill", "decode", "decode"], autoscale=reb, telemetry=sink, tracer=tracer)
    trail = []
    for _ in range(40):
        router.step()
        trail.append((reb.flip_count, reb.thrash_count, reb.fail_static, reb.fail_static_reason,
                      reb.evaluations, tuple(r.role for r in router.replicas),
                      tuple(r.state.value for r in router.replicas)))
    snap = reb.snapshot()
    metrics = router.metrics()
    return {"trail": trail, "records": sink.of("autoscale", AUTOSCALE_TIMES), "snapshot": snap,
            "autoscale_keys": sorted(k for k in metrics if k.startswith("autoscale_")),
            "flip_traces": [_tree(r) for r in tracer.completed]}


def scenario_rebalancer_chaos(side):
    """The donor killed mid-flip, then a signal outage of the chaos plan."""
    sink = Recorder()
    plan = side.resilience.FaultPlan(rebalance_fail_at=(0,), autoscale_outage_step=12,
                                     autoscale_outage_duration=3)
    reb = side.serving.RoleRebalancer(
        policy=side.serving.AutoscalePolicy(cadence_steps=1, min_dwell_steps=2, cooldown_steps=1),
        signal_reader=lambda router: _script(min(router._steps, 9)) | {"fleet_step": router._steps},
    )
    router = _router(side, roles=["prefill", "decode", "decode"], autoscale=reb, telemetry=sink,
                     fault_plan=plan)
    ids = [router.submit(p, max_new_tokens=4) for p in _prompts([5, 7], seed=8)]
    results = _step_all(router)
    for _ in range(20):
        router.step()
    return {"ids": ids, "reasons": {r.request_id: r.finish_reason for r in results},
            "tokens": {r.request_id: np.asarray(r.generated).tolist() for r in results},
            "snapshot": reb.snapshot(), "states": [r.state.value for r in router.replicas],
            "roles": [r.role for r in router.replicas], "faults": [e["fault"] for e in plan.events],
            "autoscale": sink.of("autoscale", AUTOSCALE_TIMES), "deaths": router.replica_deaths}


def scenario_signals(side):
    """The default signal read on a live fleet."""
    router = _router(side, roles=["prefill", "decode", "decode"])
    for p in _prompts([5, 7, 9, 11, 4], seed=12):
        router.submit(p, max_new_tokens=4)
    router.step()
    router.step()
    signals = side.serving.fleet_signals(router)
    signals.pop("stamp")
    _step_all(router)
    return signals


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items() if name.startswith("scenario_")}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """Each scenario's (jax, port) results, computed once per session and
    shared by the workers."""
    return scenario_runs(request, tmp_path_factory, "torch_fleet_telemetry", SCENARIOS)


# -- span trees ---------------------------------------------------------------------


TRACED = ["traced_disagg", "traced_kill", "traced_handoff_loss", "traced_spec_linear", "traced_spec_tree"]


@pytest.mark.parametrize("scenario", TRACED)
def test_span_trees_equal(runs, scenario):
    want, got = runs(scenario)
    assert sorted(got["records"]) == sorted(got["ids"]) == sorted(want["records"])
    assert got["open"] == want["open"] == 0
    for rid in got["ids"]:
        assert _tree(got["records"][rid]) == _tree(want["records"][rid]), rid


@pytest.mark.parametrize("scenario", TRACED)
def test_every_trace_is_complete(runs, scenario):
    _, got = runs(scenario)
    for record in got["records"].values():
        retired = [s for s in record["spans"] if s["kind"] == "retired"]
        assert len(retired) == 1 and retired[0]["reason"] == record["reason"]
        assert all(s["t1"] is not None and s["t1"] >= s["t0"] for s in record["spans"])


def test_disagg_trace_crosses_pools_with_one_id(runs):
    want, got = runs("traced_disagg")
    assert got["tokens"] == want["tokens"] and got["reasons"] == want["reasons"]
    for record in got["records"].values():
        replicas = {s.get("replica") for s in record["spans"] if s.get("replica")}
        assert "replica0" in replicas and replicas & {"replica1", "replica2"}
        kinds = [s["kind"] for s in record["spans"]]
        assert {"parked", "handoff_attempt", "decode", "first_token"} <= set(kinds)
    # the 30-token prompt prefills in chunks of 8; a prefill-only replica
    # decodes nothing, so no token fetch falls between its chunks and the
    # first chunk's span runs to the park
    long_rid = got["ids"][4]
    prefill = [s for s in got["records"][long_rid]["spans"] if s["kind"] == "prefill"]
    assert [(s["name"], s["span"], s["position"]) for s in prefill] == [("prefill[0]", 8, 0)]
    assert any(s.get("marks") for r in got["records"].values() for s in r["spans"])


def test_trace_counters_and_span_samples_equal(runs):
    want, got = runs("traced_disagg")
    assert got["counters"] == want["counters"]
    assert got["counters"]["traces_completed"] == len(got["ids"])
    assert got["span_keys"] == want["span_keys"]
    assert got["slo"] == want["slo"]


def test_kill_interrupts_and_reopens_spans(runs):
    want, got = runs("traced_kill")
    interrupted = [s for r in got["records"].values() for s in r["spans"] if s.get("outcome") == "replica_death"]
    assert interrupted
    assert got["slo"] == want["slo"]


def test_handoff_attempt_spans_carry_their_outcomes(runs):
    _, got = runs("traced_handoff_loss")
    (record,) = got["records"].values()
    attempts = [s for s in record["spans"] if s["kind"] == "handoff_attempt"]
    assert [s["outcome"] for s in attempts] == ["retried", "adopted"]
    assert [s["name"] for s in attempts] == ["handoff_attempt[0]", "handoff_attempt[1]"]
    assert attempts[0]["error"] == "HandoffLost"


@pytest.mark.parametrize("scenario", ["traced_spec_linear", "traced_spec_tree"])
def test_speculative_tokens_and_verify_spans(runs, scenario):
    want, got = runs(scenario)
    assert got["tokens"] == want["tokens"]
    verify = [s for r in got["records"].values() for s in r["spans"] if s["kind"] == "verify"]
    assert verify and all("accepted" in s and "emitted" in s for s in verify)


@pytest.mark.parametrize("scenario", ["traced_disagg", "traced_kill", "traced_spec_tree"])
def test_perfetto_and_summary_of_the_same_records_equal(runs, scenario):
    from accelerate_tpu.telemetry.tracing import to_perfetto as jax_perfetto
    from accelerate_tpu.telemetry.tracing import trace_summary as jax_summary

    want, got = runs(scenario)
    for records in (list(want["records"].values()), list(got["records"].values())):
        assert port_telemetry.to_perfetto(records) == jax_perfetto(records)
        assert [port_telemetry.trace_summary(r) for r in records] == [jax_summary(r) for r in records]
    events = port_telemetry.to_perfetto(list(got["records"].values()))["traceEvents"]
    assert any(e["ph"] == "X" for e in events) and json.dumps(events)
    assert port_telemetry.to_perfetto([]) == jax_perfetto([])


# -- SLO math --------------------------------------------------------------------------


def _scripted_traces():
    rng = np.random.default_rng(5)
    traces = []
    for i in range(40):
        spans = [{"kind": "decode"}]
        if i % 7 == 0:
            spans.append({"kind": "handoff_attempt", "outcome": "fell_back"})
        if i % 11 == 0:
            spans.append({"kind": "parked", "outcome": "fell_back"})
        traces.append({
            "ttft_s": None if i % 13 == 5 else float(rng.uniform(0.0, 2.0)),
            "latency_s": float(rng.uniform(0.5, 4.0)),
            "reason": ["length", "eos", "failed", "expired", "cancelled"][i % 5] if i % 3 == 0 else "length",
            "spans": spans,
        })
    return traces


def _slo_run(telemetry, stats_module):
    objectives = telemetry.default_objectives(ttft_s=1.0, window_s=10.0) + [
        telemetry.SLObjective("latency", "latency", threshold_s=3.0, target=0.9, window_s=5.0)]
    sink = Recorder()
    monitor = telemetry.SLOMonitor(objectives, telemetry=sink)
    stats = stats_module.ServingStats(4)
    evaluations = []
    for i, trace in enumerate(_scripted_traces()):
        monitor.observe(trace, stats=stats, stamp=float(i))
        if i % 8 == 7:
            evaluations.append(monitor.evaluate(stamp=float(i)))
    evaluations.append(monitor.evaluate(stamp=100.0))  # every window empty
    return evaluations, monitor.snapshot(), sink.of("slo", drop=()), (stats.slo_good_events, stats.slo_bad_events)


def test_slo_burn_rate_math_equal():
    want = _slo_run(jax_telemetry, jax_telemetry_serving)
    got = _slo_run(port_telemetry, port_telemetry_serving)
    assert got == want
    assert any(r["breached"] for r in got[0][0]) and got[0][-1][0]["burn_rate"] is None


@pytest.mark.parametrize("kwargs, match", [
    (dict(name="a", metric="p50"), "unknown SLO metric"),
    (dict(name="a", metric="ttft"), "needs threshold_s"),
    (dict(name="a", metric="error_rate", target=1.0), "target must be in"),
])
def test_slo_objective_validation_equal(kwargs, match):
    for telemetry in (jax_telemetry, port_telemetry):
        with pytest.raises(ValueError, match=match):
            telemetry.SLObjective(**kwargs)
    for telemetry in (jax_telemetry, port_telemetry):
        with pytest.raises(ValueError, match="duplicate objective names"):
            telemetry.SLOMonitor([telemetry.SLObjective("a", "error_rate")] * 2)


# -- loadgen ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_loadgen_traces_bit_equal(seed):
    for name, args, kwargs in (
        ("make_prompts", (12, 1024, 4, 40), {}),
        ("make_mixed_prompts", (16, 1024, 4, 40), dict(long_fraction=0.25, long_multiplier=4, shared_prefix=8)),
        ("make_burst_trace", (30, 5.0), dict(burst_multiplier=4.0, burst_fraction=0.5)),
        ("make_diurnal_trace", (30, 5.0), dict(period_s=3.0, amplitude=0.6)),
    ):
        want = getattr(jax_serving, name)(*args, seed=seed, **kwargs)
        got = getattr(port_serving, name)(*args, seed=seed, **kwargs)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


@pytest.mark.parametrize("call", [
    lambda m: m.make_burst_trace(0, 1.0), lambda m: m.make_burst_trace(4, 0.0),
    lambda m: m.make_burst_trace(4, 1.0, burst_multiplier=0.5), lambda m: m.make_diurnal_trace(4, 1.0, amplitude=1.0),
    lambda m: m.make_mixed_prompts(4, 16, 2, 4, long_fraction=2.0),
])
def test_loadgen_validation_equal(call):
    messages = []
    for module in (jax_serving, port_serving):
        with pytest.raises(ValueError) as error:
            call(module)
        messages.append(str(error.value))
    assert messages[0] == messages[1]


def test_offered_load_ledger_equal(runs):
    want, got = runs("offered_load")
    assert got == want
    for name in ("saturate", "burst", "uniform"):
        point = got[name]
        assert point["requests_completed"] == point["offered_requests"] == 6
        assert point["loadgen_sheds"] == point["loadgen_retries"] == 0
    assert got["shedding"]["balanced"] and got["shedding"]["requests_completed"] == 6


# -- the rebalancer ----------------------------------------------------------------------


def test_rebalancer_decisions_equal_on_scripted_signals(runs):
    want, got = runs("rebalancer")
    assert got["trail"] == want["trail"]
    assert got["snapshot"] == want["snapshot"]
    assert got["autoscale_keys"] == want["autoscale_keys"]


def test_rebalancer_records_and_flip_traces_equal(runs):
    want, got = runs("rebalancer")
    assert got["records"] == want["records"]
    assert got["flip_traces"] == want["flip_traces"]
    events = [r["event"] for r in got["records"]]
    assert "flip_completed" in events and "fail_static" in events and "fail_static_cleared" in events
    flips = [t for t in got["trail"] if t[0]]
    assert flips and got["snapshot"]["autoscale_thrash_count"] == 0


def test_rebalancer_mid_flip_kill_and_outage_equal(runs):
    want, got = runs("rebalancer_chaos")
    assert got == want
    assert got["snapshot"]["autoscale_aborted_flips"] == 1
    assert got["faults"][:1] == ["rebalance_fail"] and "autoscale_outage" in got["faults"]
    assert sorted(got["reasons"]) == sorted(got["ids"])


def test_fleet_signals_equal(runs):
    want, got = runs("signals")
    assert got == want
    assert set(got["pools"]) == {"prefill", "decode"}


def test_autoscale_policy_validation_equal():
    for module in (jax_serving, port_serving):
        with pytest.raises(ValueError, match="deadband inverted"):
            module.AutoscalePolicy(scale_up_pressure=1.0, scale_down_pressure=1.5)
        with pytest.raises(ValueError, match="must be >= 1"):
            module.AutoscalePolicy(cadence_steps=0)


# -- serve-bench ----------------------------------------------------------------------------

BENCH_ARGS = ["--model", MODEL, "--num-slots", "2", "--max-len", "64", "--requests", "4",
              "--max-new-tokens", "4", "--prompt-len-min", "3", "--prompt-len-max", "8", "--json"]
# each run's flags: the disaggregated drill with tracing, then the int8 and
# speculative replicas, an offered-load sweep, mixed prompts, arrival traces
# and the autoscale drill
BENCH_RUNS = {
    "disagg": ["--prefill-replicas", "1", "--decode-replicas", "1", "--chaos", "handoff-loss", "--trace"],
    "int8": ["--replicas", "2", "--int8", "--chaos", "replica-kill", "--offered-load", "200", "--mixed"],
    "spec": ["--replicas", "2", "--speculative", "--trace-load", "burst", "--trace-load-rps", "400"],
    "autoscale": ["--prefill-replicas", "1", "--decode-replicas", "1", "--trace-load", "diurnal",
                  "--trace-load-rps", "400", "--autoscale"],
}


def _bench(tmp_path_factory, run):
    import contextlib
    import io

    from accelerate_tpu.commands.cli import main as jax_main
    from accelerate_tpu_torch.commands.serve_bench import main as port_main

    argv = [*BENCH_ARGS, *BENCH_RUNS[run]]
    out = {}
    for name, call in (("jax", lambda d: jax_main(["serve-bench", *argv, "--trace-dir", d])),
                       ("port", lambda d: port_main([*argv, "--trace-dir", d, "--device", "cpu"]))):
        directory = str(tmp_path_factory.mktemp(f"bench-{run}-{name}"))
        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer):
            rc = call(directory)
        assert rc == 0, buffer.getvalue()
        out[name] = (json.loads(buffer.getvalue().strip().splitlines()[-1]), directory)
    return out


@pytest.fixture(scope="module")
def benches(request, tmp_path_factory):
    """A getter of one tiny serve-bench run per package for each of
    ``BENCH_RUNS`` (once per session); the last printed line is the JSON."""
    cache = {}

    def get(run):
        if run not in cache:
            cache[run] = once(request, tmp_path_factory, f"torch_fleet_telemetry_bench_{run}",
                              lambda: _bench(tmp_path_factory, run))
        return cache[run]

    return get


@pytest.fixture(scope="module")
def bench(benches):
    return benches("disagg")


def test_serve_bench_counts_equal(bench):
    """The counts that depend neither on the clock nor on the weights (no
    EOS: every request runs to its length)."""
    (want, _), (got, _) = bench["jax"], bench["port"]
    for key in ("model", "num_slots", "max_len", "requests", "max_new_tokens", "replicas",
                "prefill_replicas", "decode_replicas", "paged", "page_size"):
        assert got[key] == want[key], key
    for key in ("offered_requests", "requests_completed", "loadgen_sheds", "loadgen_retries",
                "loadgen_finish_reasons", "tokens_generated", "handoffs_adopted", "requests_parked"):
        assert got["sweep"][-1][key] == want["sweep"][-1][key], key
    drill_keys = ("chaos", "replica_deaths", "failovers", "accounted", "requests_completed",
                  "offered_requests", "handoffs_retried", "handoff_fallbacks", "handoffs_adopted")
    assert {k: got["chaos_drill"][k] for k in drill_keys} == {k: want["chaos_drill"][k] for k in drill_keys}
    assert got["chaos_drill"]["accounted"] == got["chaos_drill"]["offered_requests"] == 4
    assert got["chaos_drill"]["handoffs_retried"] == 1
    for key in ("traces_completed", "traces_open"):
        assert got["trace"][key] == want["trace"][key], key
    assert [(r["objective"], r["window_observed"]) for r in got["trace"]["slo"]] == [
        (r["objective"], r["window_observed"]) for r in want["trace"]["slo"]]


def test_serve_bench_keys_and_trace_file(bench):
    (want, _), (got, directory) = bench["jax"], bench["port"]
    dropped = {"kernels", "warmup_compile_count", "steady_state_compile_count"}
    assert set(got) == (set(want) - dropped) | {"device", "kernel_launches", "forwards"}
    assert set(got["sweep"][-1]) == set(want["sweep"][-1]) - {"compile_count"}
    assert got["device"] == "cpu" and not any(got["kernel_launches"].values())
    with open(f"{directory}/trace.json") as f:
        assert json.load(f)["traceEvents"]


# the counts of a point that depend neither on the clock nor on the weights
POINT_KEYS = ("offered_rps", "offered_requests", "requests_completed", "loadgen_sheds", "loadgen_retries",
              "loadgen_finish_reasons", "tokens_generated", "requests_submitted", "replicas")


@pytest.mark.parametrize("run", ["int8", "spec", "autoscale"])
def test_serve_bench_flag_runs_count_equal(benches, run):
    """The int8 and speculative replicas, the offered-load sweep, mixed
    prompts, arrival traces and the autoscale drill: every request runs to
    its length in every point, with the JAX version's counts."""
    (want, _), (got, _) = benches(run)["jax"], benches(run)["port"]
    for key in ("max_len", "replicas", "prefill_replicas", "decode_replicas", "int8", "speculative", "mixed"):
        assert got[key] == want[key], key
    assert [{k: p[k] for k in POINT_KEYS} for p in got["sweep"]] == [
        {k: p[k] for k in POINT_KEYS} for p in want["sweep"]]
    points = got["sweep"] + [got[k] for k in ("chaos_drill",) if k in got]
    if "load_trace" in got:
        points.append(got["load_trace"]["point"])
        assert {k: got["load_trace"]["point"][k] for k in POINT_KEYS if k != "offered_rps"} == {
            k: want["load_trace"]["point"][k] for k in POINT_KEYS if k != "offered_rps"}
    for point in points:
        assert point["loadgen_finish_reasons"] == {"length": 4}
    if "chaos_drill" in want:
        keys = ("chaos", "replica_deaths", "failovers", "accounted", "requests_completed", "offered_requests")
        assert {k: got["chaos_drill"][k] for k in keys} == {k: want["chaos_drill"][k] for k in keys}
    if "autoscale_drill" in want:
        keys = ("trace", "fixed_completed", "rebalanced_completed", "thrash_count")
        assert {k: got["autoscale_drill"][k] for k in keys} == {k: want["autoscale_drill"][k] for k in keys}
    # on the CPU no kernel launches; the target's forwards are counted all the same
    assert not any(got["kernel_launches"].values())
    forwards = got["forwards"]
    assert forwards["decode"] + forwards["verify"] > 0 and forwards["prefill"] > 0
    assert (forwards["verify"] > 0) == (run == "spec")
