"""The port's serving fleet (accelerate_tpu_torch/serving/router.py,
fleet.py, the fleet half of resilience/retry.py, resilience/chaos.py,
resilience/detector.py, parallel/redistribute.py's transfer leg and
telemetry/serving.py's handoff ledger and fleet rollup) against the JAX
package's, on the CPU in fp32 with ``llama-tiny`` and the JAX package's
weights.

Every scenario builds a router of each package over the same seeded prompts
and the same ``FaultPlan`` and runs once per module (the ``runs`` fixture
caches both results). The JAX engines run at their tests' setting (the
default ``use_kernels``, off on the CPU). The bar: tokens equal at
temperature 0 (to the JAX router's and to a lone engine's), counters and
the router's ``fleet`` records equal. Record fields measured on the wall
clock (``seconds``, ``retry_after_s`` once a step ran, ``remaining_s``)
are left out of the record comparison, and so is ``fleet_step`` where a
handoff's jittered backoff is a wall-clock gate. The scenarios follow
``tests/test_fleet.py`` and ``tests/test_disagg.py``."""

import errno
import os
from dataclasses import fields

import numpy as np
import pytest

import torch

import accelerate_tpu.resilience as jax_resilience
import accelerate_tpu.telemetry.serving as jax_telemetry_serving
import accelerate_tpu_torch.resilience as port_resilience
import accelerate_tpu_torch.serving as port_serving
import accelerate_tpu_torch.telemetry.serving as port_telemetry_serving
from accelerate_tpu_torch import Llama, ServingEngine
from torch_shared import MODEL, Recorder, one_cpu_thread, scenario_runs  # noqa: F401 - a module fixture
from torch_shared import prompts as _prompts
from torch_shared import router as _router
from torch_shared import sides as _sides
from torch_shared import step_all as _step_all

# wall-clock fields of the router's records
TIMED = ("seconds", "retry_after_s", "remaining_s")


@pytest.fixture(scope="module")
def sides():
    return _sides()


def _outcome(results):
    return {
        "terminated": sorted(r.request_id for r in results),
        "reasons": {r.request_id: r.finish_reason for r in results},
        "tokens": {r.request_id: np.asarray(r.generated).tolist() for r in results},
    }


def _counters(router):
    return {
        "failovers": router.failovers, "failed_failovers": router.failed_failovers,
        "rehomed": router.rehomed, "replica_deaths": router.replica_deaths,
        "kv_handoffs": router.kv_handoffs, "placements": list(router.placements),
        "router_sheds": router.router_sheds, "states": [r.state.value for r in router.replicas],
        "roles": [r.role for r in router.replicas], "deaths": [r.death_reason for r in router.replicas],
    }


HANDOFF_KEYS = ("requests_parked", "requests_adopted", "handoffs_attempted", "handoffs_retried",
                "handoffs_adopted", "handoff_fallbacks", "handoff_pages_moved", "handoff_bytes_moved")


def _ledger(router):
    m = router.metrics()
    return {k: m[k] for k in HANDOFF_KEYS}


# -- the scenarios, each run on both packages ------------------------------------


def scenario_replicated(side):
    prompts = _prompts([3, 7, 12, 5, 9, 4])
    router = _router(side, engine={"eos_token_id": 5})
    rows = router.generate_many(prompts, max_new_tokens=6)
    out = {"rows": [np.asarray(r).tolist() for r in rows], **_counters(router)}
    if hasattr(side, "model"):
        lone = side.engine(num_slots=2, max_len=64, eos_token_id=5)
        out["lone"] = [r.tolist() for r in lone.generate_many(prompts, max_new_tokens=6)]
    return out


def scenario_kill(side):
    plan = side.resilience.FaultPlan(replica_kill_step=3, replica_kill_index=0)
    sink = Recorder()
    router = _router(side, fault_plan=plan, telemetry=sink)
    ids = [router.submit(p, max_new_tokens=6) for p in _prompts([3, 7, 12, 5, 9, 4], seed=1)]
    results = _step_all(router)
    return {"ids": ids, **_outcome(results), **_counters(router), "records": sink.of("fleet", TIMED),
            "faults": [e["fault"] for e in plan.events]}


def scenario_heartbeat(side):
    plan = side.resilience.FaultPlan(heartbeat_loss_step=2, heartbeat_loss_index=1)
    sink = Recorder()
    router = _router(side, fault_plan=plan, telemetry=sink)
    ids = [router.submit(p, max_new_tokens=5) for p in _prompts([3, 5, 7, 4], seed=5)]
    results = _step_all(router)
    return {"ids": ids, **_outcome(results), **_counters(router), "records": sink.of("fleet", TIMED)}


def scenario_drain(side):
    sink = Recorder()
    router = _router(side, telemetry=sink, engine={"num_slots": 1, "max_queue": 8})
    prompts = _prompts([4, 5, 6, 7], seed=9)
    ids = [router.submit(p, max_new_tokens=4) for p in prompts]
    router.step()  # one request active a replica, the rest queued
    moved = router.drain_replica(0)
    draining = router.replicas[0].state.value
    with pytest.raises(side.serving.QueueFull, match="draining"):
        router.replicas[0].engine.submit(prompts[0], max_new_tokens=2)
    results = _step_all(router)
    return {"ids": ids, "moved": moved, "draining": draining, **_outcome(results), **_counters(router),
            "rehomed_stat": router.replicas[0].engine.stats.requests_rehomed, "records": sink.of("fleet", TIMED)}


def scenario_revive(side):
    sink = Recorder()
    router = _router(side, telemetry=sink)
    router.replicas[1].mark_dead("test")
    router.revive(1)
    revived = router.replicas[1].state.value
    ids = [router.submit(p, max_new_tokens=3) for p in _prompts([3, 4, 5, 6], seed=10)]
    results = _step_all(router)
    return {"ids": ids, "revived": revived, **_outcome(results), **_counters(router), "records": sink.of("fleet", TIMED)}


def scenario_health(side):
    """The health state machine on one script of degradation events."""
    seen = []
    engine = side.engine(num_slots=1, max_len=32)
    policy = side.serving.HealthPolicy(degrade_after=1, recover_after=2, drain_after=3)
    replica = side.serving.EngineReplica(
        0, engine, policy=policy, on_transition=lambda r, state, reason: seen.append((state.value, reason)))
    states = [(replica.state.value, replica.placeable, replica.alive)]
    script = ["watchdog", None, None, "quarantine", "quarantine+watchdog"]
    for events in script:
        if events:
            for event in events.split("+"):
                (engine.stats.record_watchdog_trip if event == "watchdog" else engine.stats.record_quarantine)()
        replica.observe_step()
        states.append((replica.state.value, replica.placeable, replica.alive))
    replica.mark_dead("test")
    replica.begin_recovery(side.engine(num_slots=1, max_len=32))
    states.append((replica.state.value, replica.placeable, replica.alive))
    replica.complete_recovery()
    states.append((replica.state.value, replica.placeable, replica.alive))
    return {"transitions": seen, "states": states}


def scenario_shed(side):
    """Backpressure: one queue position a replica, then the fleet sheds with
    the least quote (no step has run, so the quote is the no-history prior);
    then every replica draining: the no-placeable shed."""
    router = _router(side, engine={"num_slots": 1, "max_queue": 1})
    admitted = 0
    with pytest.raises(side.serving.QueueFull) as shed:
        for p in _prompts([4] * 10, seed=8):
            router.submit(p, max_new_tokens=4)
            admitted += 1
    out = {"admitted": admitted, "retry_after_s": shed.value.retry_after_s,
           "queue_depth": shed.value.queue_depth, "sheds": router.router_sheds,
           "by_phase": dict(router.sheds_by_phase)}
    out["drained"] = _outcome(_step_all(router))["reasons"]
    router = _router(side, engine={"num_slots": 1, "max_queue": 8})
    ids = [router.submit(p, max_new_tokens=3) for p in _prompts([4, 5], seed=21)]
    router.step()
    router.drain_replica(0)
    router.drain_replica(1)
    with pytest.raises(side.serving.QueueFull) as shed:
        router.submit(_prompts([4], seed=22)[0], max_new_tokens=3)
    out["no_placeable_positive_quote"] = shed.value.retry_after_s is not None and shed.value.retry_after_s > 0
    out["no_placeable_sheds"] = router.router_sheds
    out["no_placeable_results"] = _outcome(_step_all(router))["reasons"]
    out["no_placeable_ids"] = ids
    return out


def scenario_disagg(side):
    prompts = _prompts([3, 7, 12, 5, 9, 4])
    sink = Recorder()
    router = _router(side, roles=["prefill", "decode"], telemetry=sink)
    rows = router.generate_many(prompts, max_new_tokens=6)
    m = router.metrics()
    out = {}
    if hasattr(side, "model"):
        lone = side.engine(num_slots=2, max_len=64)
        out["lone"] = [r.tolist() for r in lone.generate_many(prompts, max_new_tokens=6)]
    return {**out, "rows": [np.asarray(r).tolist() for r in rows], **_counters(router), "ledger": _ledger(router),
            "records": sink.of("fleet", TIMED), "metric_keys": sorted(m),
            "pools": {k: m[k] for k in m if k.startswith("pool_") and k.endswith("_replicas")},
            "parked_left": router.replicas[0].engine.parked_count,
            "source_pages_left": router.replicas[0].engine.cache.pages_in_use}


def scenario_handoff_loss(side):
    """Loss at attempt 0: one retry, then the handoff adopts."""
    plan = side.resilience.FaultPlan(handoff_loss_at=(0,))
    sink = Recorder()
    router = _router(side, roles=["prefill", "decode", "decode"], fault_plan=plan, telemetry=sink)
    rid = router.submit(_prompts([6], seed=13)[0], max_new_tokens=4)
    router.step()  # prefill and park
    router.step()  # the first attempt is lost: a retry is scheduled
    first = _ledger(router)
    results = _step_all(router)
    return {"rid": rid, "after_loss": first, **_outcome(results), "ledger": _ledger(router),
            **_counters(router), "records": sink.of("fleet", TIMED + ("fleet_step",)),
            "faults": [e["fault"] for e in plan.events]}


def scenario_handoff_fallback(side):
    """Losses at attempts 0-2 (one request's whole budget): two retries and
    the fallback to re-prefill; later requests adopt."""
    plan = side.resilience.FaultPlan(handoff_loss_at=(0, 1, 2))
    sink = Recorder()
    router = _router(side, roles=["prefill", "decode"], fault_plan=plan, telemetry=sink)
    prompts = _prompts([5, 8, 6], seed=2)
    ids = [router.submit(prompts[0], max_new_tokens=5)]
    results = _step_all(router)
    after_first = _ledger(router)
    ids += [router.submit(p, max_new_tokens=5) for p in prompts[1:]]
    results += _step_all(router)
    return {"ids": ids, "after_first": after_first, **_outcome(results), "ledger": _ledger(router),
            **_counters(router), "records": sink.of("fleet", TIMED + ("fleet_step",)),
            "faults": [e["fault"] for e in plan.events],
            "parked_left": router.replicas[0].engine.parked_count,
            "source_pages_left": router.replicas[0].engine.cache.pages_in_use}


def scenario_prefill_kill(side):
    """The prefill replica dies with KV parked: every request re-prefills on
    the decode replica, which turns mixed."""
    plan = side.resilience.FaultPlan(replica_kill_step=2, replica_kill_index=0)
    sink = Recorder()
    router = _router(side, roles=["prefill", "decode"], fault_plan=plan, telemetry=sink)
    ids = [router.submit(p, max_new_tokens=6) for p in _prompts([3, 7, 12, 5, 9, 4], seed=1)]
    results = _step_all(router)
    return {"ids": ids, **_outcome(results), **_counters(router), "ledger": _ledger(router),
            "records": sink.of("fleet", TIMED)}


def scenario_prefill_pool_dead(side):
    sink = Recorder()
    router = _router(side, roles=["prefill", "prefill", "decode"], telemetry=sink)
    router._on_replica_death(router.replicas[0], "test kill")
    roles_one_dead = [r.role for r in router.replicas]
    router._on_replica_death(router.replicas[1], "test kill")
    ids = [router.submit(p, max_new_tokens=4) for p in _prompts([4, 6], seed=4)]
    results = _step_all(router)
    return {"ids": ids, "roles_one_dead": roles_one_dead, **_outcome(results), **_counters(router),
            "records": sink.of("fleet", TIMED)}


def scenario_decode_pool_dead(side):
    """The decode pool dies with KV parked: the source turns mixed and
    resumes its own parked pages, moving no byte."""
    router = _router(side, roles=["prefill", "decode"])
    rid = router.submit(_prompts([6], seed=5)[0], max_new_tokens=4)
    router.step()
    parked = router.replicas[0].engine.parked_count
    router._on_replica_death(router.replicas[1], "test kill")
    results = _step_all(router)
    return {"rid": rid, "parked": parked, **_outcome(results), **_counters(router), "ledger": _ledger(router)}


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items() if name.startswith("scenario_")}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """Each scenario's (jax, port) results, computed once per session and
    shared by the workers."""
    return scenario_runs(request, tmp_path_factory, "torch_fleet", SCENARIOS)


# -- replicated fleet -------------------------------------------------------------


def test_routed_tokens_equal_jax_router_and_lone_engine(runs):
    want, got = runs("replicated")
    assert got["rows"] == want["rows"] == got["lone"]
    assert got["placements"] == want["placements"] and all(p > 0 for p in got["placements"])


@pytest.mark.parametrize("scenario", ["kill", "heartbeat", "drain", "revive"])
def test_drill_terminates_every_request_once_with_equal_tokens(runs, scenario):
    want, got = runs(scenario)
    assert got["terminated"] == sorted(got["ids"]) == want["terminated"]
    assert got["reasons"] == want["reasons"]
    assert got["tokens"] == want["tokens"]


@pytest.mark.parametrize("scenario", ["kill", "heartbeat", "drain", "revive"])
def test_drill_counters_and_fleet_records_equal(runs, scenario):
    want, got = runs(scenario)
    for key in ("failovers", "failed_failovers", "rehomed", "replica_deaths", "placements", "states", "deaths"):
        assert got[key] == want[key], key
    assert got["records"] == want["records"]


def test_kill_drill_fires_once_and_fails_over(runs):
    want, got = runs("kill")
    assert got["faults"] == want["faults"] == ["replica_kill"]
    assert got["replica_deaths"] == 1 and got["failovers"] > 0
    assert [r["event"] for r in got["records"]].count("replica_death") == 1


def test_heartbeat_loss_marks_the_silent_replica_dead(runs):
    _, got = runs("heartbeat")
    assert got["states"][1] == "dead" and got["deaths"][1] == "heartbeat lost"


def test_drain_rehomes_the_queue_and_dies_empty(runs):
    want, got = runs("drain")
    assert got["moved"] == want["moved"] >= 1
    assert got["draining"] == "draining"
    assert got["rehomed_stat"] == want["rehomed_stat"] == got["moved"]
    assert got["deaths"][0] == "drained"


def test_revive_returns_the_replica_to_rotation(runs):
    want, got = runs("revive")
    assert got["revived"] == want["revived"] == "healthy"
    assert got["placements"][1] > 0


def test_health_state_machine_equal(runs):
    want, got = runs("health")
    assert got == want
    assert [s for s, _ in got["transitions"]] == [
        "degraded", "healthy", "degraded", "draining", "dead", "recovering", "healthy"]


def test_shed_count_and_least_quote_equal(runs):
    want, got = runs("shed")
    assert got["admitted"] == want["admitted"] == 2
    assert got["sheds"] == want["sheds"] == 1
    assert got["by_phase"] == want["by_phase"]
    assert got["queue_depth"] == want["queue_depth"]
    # no step has run: the quote is the no-history prior (JAX rounds it to 4 places)
    assert got["retry_after_s"] == pytest.approx(want["retry_after_s"], abs=5e-5)
    assert got["drained"] == want["drained"]
    for key in ("no_placeable_positive_quote", "no_placeable_sheds", "no_placeable_results"):
        assert got[key] == want[key], key
    assert got["no_placeable_positive_quote"]


# -- disaggregated pools ----------------------------------------------------------


def test_disagg_tokens_equal_jax_router_and_lone_engine(runs):
    want, got = runs("disagg")
    assert got["rows"] == want["rows"] == got["lone"]
    assert got["kv_handoffs"] == want["kv_handoffs"] == 6
    assert got["records"] == want["records"]


def test_disagg_handoff_ledger_equal(runs):
    """Every request parked on the prefill replica and was adopted on the
    decode replica: the ledger the router records on the source's stats,
    pages and bytes included (both pools hold fp32 pages of one shape)."""
    want, got = runs("disagg")
    assert got["ledger"] == want["ledger"]
    assert got["ledger"]["handoffs_adopted"] == got["ledger"]["requests_parked"] == 6
    assert got["ledger"]["handoff_bytes_moved"] > 0
    assert got["pools"] == want["pools"] == {"pool_decode_replicas": 1, "pool_prefill_replicas": 1}
    assert got["parked_left"] == got["source_pages_left"] == 0


def test_disagg_metric_keys_match_the_jax_router(runs):
    """The router's metrics keep the JAX keys, less the XLA compile count
    (no counterpart in an eager port)."""
    want, got = runs("disagg")
    assert set(got["metric_keys"]) == set(want["metric_keys"]) - {"compile_count"}
    for key in ("handoff_p50_ms", "handoff_p99_ms", "span_handoff_attempt_p50_ms"):
        assert (key in got["metric_keys"]) == (key in want["metric_keys"]), key


def test_handoff_loss_retries_then_adopts(runs):
    want, got = runs("handoff_loss")
    assert got["after_loss"] == want["after_loss"]
    assert got["after_loss"]["handoffs_attempted"] == 1  # not one a decode replica
    assert got["after_loss"]["handoffs_retried"] == 1
    assert got["ledger"] == want["ledger"]
    assert (got["ledger"]["handoffs_adopted"], got["ledger"]["handoff_fallbacks"]) == (1, 0)
    assert got["tokens"] == want["tokens"] and got["reasons"] == want["reasons"]
    assert got["records"] == want["records"]
    assert got["faults"] == want["faults"] == ["handoff_loss"]


def test_handoff_loss_past_the_budget_falls_back_to_reprefill(runs):
    want, got = runs("handoff_fallback")
    assert got["after_first"] == want["after_first"]
    assert (got["after_first"]["handoffs_retried"], got["after_first"]["handoff_fallbacks"],
            got["after_first"]["handoffs_adopted"]) == (2, 1, 0)
    assert got["ledger"]["handoffs_adopted"] == 2
    assert got["terminated"] == sorted(got["ids"]) == want["terminated"]
    assert got["tokens"] == want["tokens"]
    assert got["records"] == want["records"]
    assert got["faults"] == want["faults"] == ["handoff_loss"] * 3
    assert got["parked_left"] == got["source_pages_left"] == 0


def test_prefill_kill_with_kv_parked_falls_back_exactly_once(runs):
    want, got = runs("prefill_kill")
    assert got["terminated"] == sorted(got["ids"]) == want["terminated"]
    assert got["tokens"] == want["tokens"] and set(got["reasons"].values()) == {"length"}
    for key in ("replica_deaths", "failovers", "roles", "states", "kv_handoffs"):
        assert got[key] == want[key], key
    assert got["roles"][1] == "mixed"
    assert got["ledger"] == want["ledger"]
    assert got["records"] == want["records"]
    assert any(r["event"] == "pool_degraded" for r in got["records"])


def test_dead_prefill_pool_degrades_to_mixed(runs):
    want, got = runs("prefill_pool_dead")
    assert got["roles_one_dead"] == want["roles_one_dead"] == ["prefill", "prefill", "decode"]
    assert got["roles"] == want["roles"] and got["roles"][2] == "mixed"
    assert got["tokens"] == want["tokens"] and got["kv_handoffs"] == want["kv_handoffs"] == 0
    assert got["records"] == want["records"]


def test_dead_decode_pool_resumes_parked_kv_in_place(runs):
    want, got = runs("decode_pool_dead")
    assert got["parked"] == want["parked"] == 1
    assert got["tokens"] == want["tokens"]
    assert got["ledger"] == want["ledger"]
    assert got["ledger"]["handoffs_adopted"] == 1 and got["ledger"]["handoff_bytes_moved"] == 0


# -- the chaos plan, the classifiers, the rollup ----------------------------------

CHAOS_ENV = {
    "ACCELERATE_CHAOS_SEED": "3", "ACCELERATE_CHAOS_NAN_STEPS": "2, 5", "ACCELERATE_CHAOS_NAN_TARGET": "loss",
    "ACCELERATE_CHAOS_IO_FAILURES": "2", "ACCELERATE_CHAOS_STALL_STEPS": "4",
    "ACCELERATE_CHAOS_STALL_SECONDS": "0.01", "ACCELERATE_CHAOS_SIGTERM_STEP": "9",
    "ACCELERATE_CHAOS_SERVING_BURST_STEP": "1", "ACCELERATE_CHAOS_SERVING_BURST_SIZE": "4",
    "ACCELERATE_CHAOS_REPLICA_KILL_STEP": "7", "ACCELERATE_CHAOS_REPLICA_KILL_INDEX": "1",
    "ACCELERATE_CHAOS_REPLICA_STALL_STEP": "3", "ACCELERATE_CHAOS_REPLICA_STALL_INDEX": "2",
    "ACCELERATE_CHAOS_HEARTBEAT_LOSS_STEP": "5", "ACCELERATE_CHAOS_HEARTBEAT_LOSS_INDEX": "1",
    "ACCELERATE_CHAOS_HOST_LOSS_STEP": "6", "ACCELERATE_CHAOS_HOST_LOSS_INDEX": "1",
    "ACCELERATE_CHAOS_MEMBERSHIP_SILENCE_STEP": "2", "ACCELERATE_CHAOS_MEMBERSHIP_SILENCE_INDEX": "3",
    "ACCELERATE_CHAOS_MEMBERSHIP_STALL_STEP": "4", "ACCELERATE_CHAOS_MEMBERSHIP_STALL_INDEX": "2",
    "ACCELERATE_CHAOS_HANDOFF_STALL_AT": "0,2", "ACCELERATE_CHAOS_HANDOFF_LOSS_AT": "1",
    "ACCELERATE_CHAOS_REDISTRIBUTE_FAIL_AT": "3", "ACCELERATE_CHAOS_REDISTRIBUTE_FAIL_STAGE": "1",
    "ACCELERATE_CHAOS_REBALANCE_FAIL_AT": "0", "ACCELERATE_CHAOS_AUTOSCALE_OUTAGE_STEP": "8",
    "ACCELERATE_CHAOS_AUTOSCALE_OUTAGE_DURATION": "2", "ACCELERATE_CHAOS_SPEC_DISABLE_STEP": "11",
}


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in fields(plan) if f.name not in ("sink",)}


@pytest.mark.parametrize("env", ["all", "one", "none"])
def test_fault_plan_from_env_equal(monkeypatch, env):
    for key in [k for k in os.environ if k.startswith("ACCELERATE_CHAOS_")]:
        monkeypatch.delenv(key)
    chosen = {"all": CHAOS_ENV, "one": {"ACCELERATE_CHAOS_HANDOFF_LOSS_AT": "0"}, "none": {}}[env]
    for key, value in chosen.items():
        monkeypatch.setenv(key, value)
    want, got = jax_resilience.FaultPlan.from_env(), port_resilience.FaultPlan.from_env()
    if env == "none":
        assert want is None and got is None
        return
    assert _plan_fields(got) == _plan_fields(want)
    assert got.active and want.active


def test_fault_plan_predicates_and_ledger_equal():
    """Every predicate of the two plans on the same calls: what fires, what
    the ledger records, in order."""
    kwargs = dict(seed=3, nan_steps=(2, 5), nan_target="loss", io_failures=2, stall_steps=(4,),
                  stall_seconds=0.0, serving_burst_step=1, serving_burst_size=4, replica_kill_step=7,
                  replica_kill_index=1, replica_stall_step=3, replica_stall_index=2, heartbeat_loss_step=5,
                  heartbeat_loss_index=1, host_loss_step=6, host_loss_index=1, membership_silence_step=2,
                  membership_silence_index=3, membership_stall_step=4, membership_stall_index=2,
                  handoff_stall_at=(0, 2), handoff_loss_at=(1,), redistribute_fail_at=(3,),
                  redistribute_fail_stage=1, rebalance_fail_at=(0,), autoscale_outage_step=8,
                  autoscale_outage_duration=2, spec_disable_step=11)
    outs = []
    for module in (jax_resilience, port_resilience):
        plan = module.FaultPlan(**kwargs)
        calls = []
        for step in range(12):
            calls.append((
                plan.corrupt_target(step), plan.serving_burst(step), plan.spec_disable(step),
                plan.replica_kill(step), plan.replica_kill(step, valid=lambda i: False),
                plan.replica_stall(step), plan.heartbeat_loss(step), plan.host_loss(step),
                plan.membership_silent(3, step), plan.membership_stall(2, step),
                plan.handoff_stall(step), plan.handoff_loss(step), plan.rebalance_fail(step),
                plan.autoscale_outage(step), plan.redistribute_fail(step, 1, "paged_extract"),
            ))
        for site in ("save", "load", "save"):
            try:
                plan.probe_io(site)
                calls.append(("io", site, None))
            except OSError as error:
                calls.append(("io", site, error.errno))
        outs.append((calls, plan.events))
    assert outs[1] == outs[0]
    assert ("io", "save", errno.EIO) in outs[1][0]


def test_chaos_activation_is_read_by_a_router_built_without_a_plan(sides):
    plan = port_resilience.FaultPlan(replica_kill_step=0, replica_kill_index=0)
    from accelerate_tpu_torch.resilience import chaos

    chaos.activate(plan)
    try:
        router = _router(sides["port"])
        assert router.chaos is plan and chaos.active_plan() is plan
    finally:
        chaos.deactivate()
    assert chaos.active_plan() is None


def _errors(side):
    return [
        side.serving.ReplicaLost("gone", replica_index=1), side.serving.QueueFull("full"),
        side.serving.HandoffLost("lost"), ValueError("malformed"), OSError(errno.EIO, "eio"),
        OSError(errno.ENOENT, "missing"), RuntimeError("other"), TimeoutError("slow"),
    ]


def test_retry_classifiers_and_policies_equal(sides):
    verdicts = {}
    for name, module in (("jax", jax_resilience), ("port", port_resilience)):
        errors = _errors(sides[name])
        verdicts[name] = (
            [module.is_fleet_transient(e) for e in errors],
            [module.is_handoff_transient(e) for e in errors],
        )
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][0][:3] == [True, True, False] and verdicts["port"][1][:4] == [True, True, True, False]
    for policy in ("FLEET_RETRY", "HANDOFF_RETRY"):
        want, got = getattr(jax_resilience, policy), getattr(port_resilience, policy)
        assert (got.max_attempts, got.base_delay, got.max_delay, got.jitter) == (
            want.max_attempts, want.base_delay, want.max_delay, want.jitter)


@pytest.mark.parametrize("timeout", [None, 0.5])
def test_silence_detector_equal(timeout):
    from accelerate_tpu.resilience import SilenceDetector as JaxDetector

    want, got = JaxDetector(timeout), port_resilience.SilenceDetector(timeout)
    for last, now in ((0.0, 0.25), (0.0, 0.5), (0.0, 0.5000001), (1.0, 3.0)):
        assert got.expired(last, now) == want.expired(last, now)
        assert got.silent_for(last, now) == want.silent_for(last, now)


def _fill_stats(module, seed):
    """Two replicas' stats fed the same seeded samples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        stats = module.ServingStats(4, num_pages=33, page_size=16)
        for _ in range(6 + i):
            stats.record_step(float(rng.uniform(0.01, 0.03)), active=int(rng.integers(1, 5)),
                              waiting=int(rng.integers(0, 3)), pages_in_use=int(rng.integers(0, 33)))
        for _ in range(3):
            stats.record_submit()
            stats.record_first_token(float(rng.uniform(0.1, 0.4)))
            stats.record_finish(float(rng.uniform(0.5, 1.0)))
        stats.record_prefix_hit(16)
        stats.record_prefix_miss()
        stats.record_handoff_attempt()
        stats.record_handoff_attempt()
        stats.record_handoff_retry()
        stats.record_handoff(3, 3 * 4096, float(rng.uniform(0.001, 0.002)))
        stats.record_handoff_fallback()
        stats.record_span("decode", float(rng.uniform(0.1, 0.2)))
        stats.record_span("queued", float(rng.uniform(0.0, 0.05)))
        stats.record_trace_completed()
        stats.record_slo_event(True)
        stats.record_slo_event(i == 0)
        stats.record_spec_step(4, [1, 3])
        out.append(stats)
    return out


@pytest.mark.parametrize("roles", [None, ["prefill", "decode"]])
def test_fleet_rollup_equal(roles):
    """The rollup of the same samples; the JAX package rounds (3 places for
    ms, 4 for occupancy and rates), the port reports unrounded: equal
    within that rounding. Throughput reads the wall clock and is left out."""
    want = jax_telemetry_serving.fleet_rollup(_fill_stats(jax_telemetry_serving, 0), roles=roles)
    got = port_telemetry_serving.fleet_rollup(_fill_stats(port_telemetry_serving, 0), roles=roles)
    assert set(got) == set(want)
    for key in sorted(want):
        if key == "throughput_tokens_per_sec":
            continue
        if isinstance(want[key], float):
            assert got[key] == pytest.approx(want[key], abs=6e-4), key
        else:
            assert got[key] == want[key], key
    assert got["handoffs_adopted"] == 2 and got["handoff_fallbacks"] == 2 and got["slo_bad_events"] == 1


def test_stats_snapshot_handoff_and_trace_keys_equal():
    want = _fill_stats(jax_telemetry_serving, 1)[0].snapshot()
    got = _fill_stats(port_telemetry_serving, 1)[0].snapshot()
    assert set(got) == set(want)
    for key in HANDOFF_KEYS + ("traces_completed", "trace_spans", "slo_good_events", "slo_bad_events"):
        assert got[key] == want[key], key
    for key in ("handoff_p50_ms", "handoff_p99_ms", "span_decode_p50_ms", "span_queued_p99_ms"):
        assert got[key] == pytest.approx(want[key], abs=6e-4), key


# -- the port's own rules -----------------------------------------------------------


def test_replicas_share_one_copy_of_the_weights(sides):
    """A router's engines all serve the model they were built over: no
    engine holds a cast or a copy of a weight."""
    model = sides["port"].model
    weights = [(id(t), t.data_ptr()) for t in model.parameters()]
    router = _router(sides["port"], n=3)
    assert all(replica.engine.model is model for replica in router.replicas)
    assert [(id(t), t.data_ptr()) for t in model.parameters()] == weights


def test_router_without_a_card_raises():
    """``device=None`` means CUDA: with no card the fleet's engines raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the engines would run there")
    model = Llama(MODEL, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serving.ServingRouter(engine_factory=lambda: ServingEngine(model), num_replicas=2)


def test_analyze_names_its_item(sides):
    router = _router(sides["port"])
    with pytest.raises(NotImplementedError, match="item 21"):
        router.analyze()


def test_router_validates_roles_like_the_jax_router(sides):
    for name in ("jax", "port"):
        side = sides[name]
        with pytest.raises(ValueError, match="roles= names"):
            side.serving.ServingRouter(engine_factory=lambda: side.engine(num_slots=2, max_len=64),
                                       num_replicas=2, roles=["prefill"])
        with pytest.raises(ValueError, match="prefill-capable"):
            _router(side, roles=["decode", "decode"])
        with pytest.raises(ValueError, match="dense slab"):
            _router(side, roles=["prefill", "decode"], engine={"paged": False})
