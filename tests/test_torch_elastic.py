"""Elastic training across processes: the port's ElasticCoordinator in 4 gloo
processes on the CPU against the JAX package's on its 8-device mesh.

One launch (``torch_elastic_workers.suite``, shared with
``test_torch_redistribute.py`` and ``test_torch_local_sgd.py`` through
``torch_shared.elastic_launch``) runs every scenario; the JAX package's
coordinator runs the same schedules meanwhile, 4 hosts of 2 devices, its
boundary recovered before each batch is taken, as the port's harness does.
The SIGKILL drill has its own 4 processes and its own harness (the dead
rank's exit is its point).

Tolerances, and why (llama-tiny, fp32, adamw 1e-3):
- losses against the JAX package's: rtol 1e-5 (the same sums in other
  orders: 3 or 4 processes against 6 or 8 devices); under fp16 1e-3, the
  bound ``test_torch_training.py`` holds fp16 losses to (each product
  rounded to fp16, in other orders);
- the final params against the JAX package's: the largest difference
  within ``2 * lr * steps`` and the mean one within 1e-5, as
  ``test_torch_parallel.py`` holds them (Adam moves a param by about
  ``lr`` a step whatever its gradient's size);
- the relayouts (the shrink, the regrow, the SIGKILL recovery, FSDP stage
  2's shrink): the whole params and optimizer state bit for bit across
  each; every process ends with the same params bit for bit.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_shared import ELASTIC_STEPS, elastic_launch  # noqa: E402

LR = 1e-3
LOSS_RTOL = 1e-5
FP16_LOSS_RTOL = 1e-3  # fp16 activations rounded in other orders (test_torch_training.py's fp16 bound)
PARAM_MEAN_ATOL = 1e-5


@pytest.fixture(scope="module")
def launch(request, tmp_path_factory):
    return elastic_launch(request, tmp_path_factory)


def _survivors(ranks, key):
    return [r[key] for r in ranks if not r[key].get("lost")]


def _params_close(port: dict, jax: dict, steps: int):
    assert port.keys() == jax.keys()
    for name in port:
        diff = np.abs(port[name] - jax[name])
        assert diff.max() <= 2 * LR * steps, (name, diff.max())
        assert diff.mean() <= PARAM_MEAN_ATOL, (name, diff.mean())


def test_drill_buddy_shrink_and_regrow_against_the_jax_coordinator(launch):
    """Host 1 of 4 lost by chaos at boundary 3: the buddy rung, no step
    lost, 3 processes train on; the host asks back in and is admitted by
    its join record at boundary 6 (the staged regrow). Losses and final
    params agree with the JAX coordinator's on the same schedule; the
    whole state crosses both relayouts bit for bit."""
    ranks = [r["drill"] for r in launch["port"]]
    jax_run = launch["jax"]["drill"]
    survivors = [r for i, r in enumerate(ranks) if i != 1]
    for r in survivors:
        assert r["checks"][3] == {"bit_equal": True, "members": [0, 2, 3]}
        assert r["checks"][6] == {"bit_equal": True, "members": [0, 1, 2, 3]}
        events = [x["event"] for x in r["recoveries"]]
        assert events == ["recovered", "regrown"]
        recovered, regrown = r["recoveries"]
        assert recovered["rung"] == "buddy" and recovered["steps_lost"] == 0 and recovered["mttr_s"] > 0
        assert recovered["mesh"]["data"] == 3 and recovered["epoch"] == 2
        assert regrown["hosts"] == [1] and regrown["mesh"]["data"] == 4 and regrown["epoch"] == 3
        assert r["epoch"] == 3
        np.testing.assert_allclose([r["losses"][i] for i in range(ELASTIC_STEPS)],
                                   [jax_run["losses"][i] for i in range(ELASTIC_STEPS)], rtol=LOSS_RTOL)
    assert [x["rung"] for x in jax_run["recoveries"] if x["event"] == "recovered"] == ["buddy"]
    # the returning process ran the steps after its return, with the others
    assert sorted(ranks[1]["losses"]) == [0, 1, 5, 6, 7]
    assert all(ranks[1]["losses"][i] == ranks[0]["losses"][i] for i in (5, 6, 7))
    _params_close(ranks[0]["final"]["params"], jax_run["params"], ELASTIC_STEPS)
    for r in ranks[1:]:
        assert all(np.array_equal(r["final"]["params"][k], ranks[0]["final"]["params"][k]) for k in r["final"]["params"])


def test_drill_records_the_plan_the_mirror_and_the_departure(launch):
    """The telemetry of the drill: the mirror's bytes a process, the loss
    and its relay (host relay, one stage a leaf), the regrow's staged
    transfer (all-to-all stages), the departure and the return."""
    ranks = [r["drill"] for r in launch["port"]]
    for i, r in enumerate(ranks):
        elastic = [p for k, p in r["records"] if k == "elastic"]
        moved = [p for k, p in r["records"] if k == "redistribute"]
        assert elastic[0]["event"] == "redundancy_allocated" and elastic[0]["buddy_bytes_per_chip"] == r["mirror_bytes"] > 0
        if i == 1:
            assert [p["event"] for p in elastic if p["event"] != "redundancy_allocated"] == ["host_departed", "rejoined"]
            assert [p["path"] for p in moved] == ["staged", "staged"]
            continue
        assert [p["path"] for p in moved] == ["host_relay", "host_relay", "staged", "staged"]
        relay_params, relay_state, staged_params, staged_state = moved
        assert relay_params["stage_kinds"] == {"host_relay": relay_params["leaves"]}
        assert set(staged_params["stage_kinds"]) <= {"all_to_all", "collective_permute"}
        assert all(p["outcome"] == "committed" for p in moved)
        assert relay_state["bytes_moved"] == staged_state["bytes_moved"]
        assert "host_loss_detected" in [p["event"] for p in elastic]


def test_stale_mirror_falls_to_the_checkpoint_rung_with_the_jax_steps_lost(launch):
    """``mirror_every=2``, a checkpoint at step 2, host 2 lost at boundary 4
    (the mirror is a step stale): the survivors reload the checkpoint (a
    4-process checkpoint onto 3), one step is lost, as the JAX ladder counts
    it, and the losses of the re-run steps agree with the JAX package's."""
    ranks = [r["checkpoint"] for r in launch["port"]]
    jax_run = launch["jax"]["checkpoint"]
    assert ranks[2]["lost"] and not ranks[2]["recoveries"]
    jax_recovered = [x for x in jax_run["recoveries"] if x["event"] == "recovered"]
    for r in (ranks[0], ranks[1], ranks[3]):
        [recovered] = r["recoveries"]
        assert recovered["rung"] == "checkpoint" and recovered["tried"] == ["buddy", "checkpoint"]
        assert recovered["steps_lost"] == jax_recovered[0]["steps_lost"] == 1
        assert recovered["resumed_at_step"] == jax_recovered[0]["resumed_at_step"] == 2
        np.testing.assert_allclose([r["losses"][i] for i in range(6)], [jax_run["losses"][i] for i in range(6)],
                                   rtol=LOSS_RTOL)
    _params_close(ranks[0]["final"]["params"], jax_run["params"], 6)


def test_the_ladder_fails_loudly_with_nothing_left_and_on_an_infeasible_mesh(launch):
    """No redundancy and no checkpoint: ElasticFailure, recorded as
    ``recovery_failed``, as the JAX package fails; and a loss whose
    survivors cannot form a mesh fails on its own rung, recorded."""
    ranks = [r["nothing_left"] for r in launch["port"]]
    jax_run = launch["jax"]["fail"]
    assert ranks[1] == {"lost": True}
    assert jax_run["last"]["event"] == "recovery_failed"
    for r in (ranks[0], ranks[2], ranks[3]):
        assert "no checkpoint_dir configured" in r["error"] and "no checkpoint_dir configured" in jax_run["error"]
        assert r["last"]["event"] == "recovery_failed" and r["last"]["rung"] == "fail"
        assert r["last"]["tried"] == jax_run["last"]["tried"] == []
        assert "cannot form a training mesh" in r["infeasible"]
        assert r["infeasible_last"]["event"] == "recovery_failed"
        assert [p["event"] for _, p in r["records"]].count("recovery_failed") == 2


def test_fp16_scaler_crosses_a_shrink_losing_host_zero(launch):
    """The replicated loss scale and its growth tracker cross a shrink that
    loses process 0, intact, as the JAX coordinator's do on the same
    schedule; the losses before and after it, reported unscaled, agree
    with the JAX package's within ``FP16_LOSS_RTOL``."""
    ranks = [r["fp16"] for r in launch["port"]]
    jax_run = launch["jax"]["fp16"]
    assert ranks[0] == {"lost": True}
    assert [x["rung"] for x in jax_run["recoveries"] if x["event"] == "recovered"] == ["buddy"]
    assert jax_run["scaler"]["after"] == jax_run["scaler"]["before"]
    for r in ranks[1:]:
        assert r["rung"] == "buddy"
        assert (r["scale_before"], r["growth_before"]) == jax_run["scaler"]["before"]
        assert (r["scale_after"], r["growth_after"]) == jax_run["scaler"]["after"]
        np.testing.assert_allclose(r["losses"], [jax_run["losses"][i] for i in range(3)], rtol=FP16_LOSS_RTOL)
    assert ranks[1]["losses"] == ranks[2]["losses"] == ranks[3]["losses"]


def test_fsdp_stage2_moments_stay_sharded_across_a_shrink(launch):
    """FSDP stage 2 on 2 hosts of 2 processes, host 1 lost: on the 2
    survivors (``fsdp=2``) the params stay whole, the moments sharded in
    half, and the whole state crosses the shrink bit for bit."""
    ranks = [r["stage2"] for r in launch["port"]]
    assert ranks[2] == ranks[3] == {"lost": True}
    for r in ranks[:2]:
        assert r["bit_equal"] and r["mesh"]["fsdp"] == 2 and r["mesh"]["data"] == 1
        whole = r["whole_state_shapes"]
        held = r["state_shapes"]
        sharded = [h for h, w in zip(held, whole) if tuple(h) != tuple(w)]
        assert sharded and all(int(np.prod(h)) * 2 == int(np.prod(w)) for h, w in zip(held, whole) if tuple(h) != tuple(w))
        assert np.isfinite(r["loss"])


def test_prefetched_batches_are_cut_again_for_the_shrunken_group(launch):
    """A loader's batch prefetched for 4 processes, consumed after process
    3 left and the others formed a group of 3, is cut again from its
    global rows: the global stream is unchanged (no row skipped or
    repeated)."""
    ranks = [r["remesh"] for r in launch["port"]]
    rows = np.arange(48).reshape(24, 2)
    assert np.array_equal(np.concatenate([r["first"] for r in ranks]), rows[:12])
    assert ranks[3]["left"]
    assert np.array_equal(np.concatenate([r["second"] for r in ranks[:3]]), rows[12:])


def test_a_real_death_is_named_by_silence_and_recovered(launch):
    """Process 3 killed by SIGKILL after step 2: the survivors' next
    boundary finds no record of it, the detector names host 3 by its
    heartbeat silence, the buddy rung recovers with the whole state
    bit-equal to the state before the death (no half step read), and the
    losses go on as the chaos drill's."""
    result = launch["sigkill"]
    assert result["exit_codes"] == [0, 0, 0, -9], result
    drill = launch["port"][0]["drill"]["losses"]
    for rank in range(3):
        r = result["survivors"][rank]
        assert r["bit_equal"] and r["members"] == [0, 1, 2]
        [recovered] = r["recoveries"]
        assert recovered["rung"] == "buddy" and recovered["host"] == 3 and recovered["steps_lost"] == 0
        assert [s["reason"] for s in r["suspected"]] == ["heartbeat_silence"]
        assert [r["losses"][i] for i in range(4)] == [drill[i] for i in range(4)]


def test_elastic_config_validation_and_refusals():
    """The config's checks as the JAX package's; ``contracts_dir`` (the
    program audit) and ``cpu_offload`` are refused, naming why."""
    from accelerate_tpu import ElasticConfig as JaxElasticConfig
    from accelerate_tpu_torch import Accelerator, ElasticConfig, FullyShardedDataParallelPlugin, Llama, fused_adamw
    from accelerate_tpu_torch.resilience.elastic import buddy_mesh, host_device_groups
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for bad, match in ((dict(redundancy=2), "redundancy"), (dict(mirror_every=0), "mirror_every")):
        with pytest.raises(ValueError, match=match):
            ElasticConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JaxElasticConfig(**bad)
    with pytest.raises(NotImplementedError, match="item 21"):
        ElasticConfig(contracts_dir="contracts")
    groups = host_device_groups(list(range(8)), 4)
    assert groups == [[0, 1], [2, 3], [4, 5], [6, 7]]
    host_of = {m: h for h, g in enumerate(groups) for m in g}
    assert all(host_of[p] != host_of[b] for p, b in zip(range(8), buddy_mesh(list(range(8)), 2)))
    with pytest.raises(ValueError, match="divide"):
        host_device_groups(list(range(8)), 3)
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    try:
        acc = Accelerator(device="cpu", fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True))
        model = Llama("llama-tiny", device="cpu")
        acc.prepare_model(model)
        acc.prepare_optimizer(fused_adamw(1e-3))
        with pytest.raises(ValueError, match="cpu_offload"):
            acc.elastic_coordinator(Llama.loss_fn(model))
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()


def test_store_outage_degrades_the_boundary_as_in_the_jax_package(tmp_path):
    """The membership store unreachable past its retries (every store
    operation failing): the boundary's membership work degrades to a
    ``store_degraded`` record and the step runs, in both packages."""
    import optax

    import accelerate_tpu.resilience.chaos as jax_chaos
    import accelerate_tpu_torch.resilience.chaos as port_chaos
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import ElasticConfig as JaxElasticConfig
    from accelerate_tpu.models import Llama as JaxLlama
    from accelerate_tpu.resilience import FaultPlan as JaxFaultPlan
    from accelerate_tpu.resilience.membership import FilesystemStore as JaxFilesystemStore
    from accelerate_tpu.resilience.membership import MembershipService as JaxMembershipService
    from accelerate_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
    from accelerate_tpu_torch import Accelerator, ElasticConfig, FaultPlan, Llama, fused_adamw
    from accelerate_tpu_torch.resilience.membership import FilesystemStore, MembershipService
    from accelerate_tpu_torch.resilience.retry import RetryPolicy
    from torch_shared import _jax_reset

    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    ids = np.random.default_rng(0).integers(0, 1024, (8, 16)).astype(np.int32)
    ops = {}
    for side in ("jax", "port"):
        _jax_reset()
        AcceleratorState._reset_state()
        GradientState._reset_state()
        PartialState._reset_state()
        fast = (JaxRetryPolicy if side == "jax" else RetryPolicy)(max_attempts=2, base_delay=0.001, max_delay=0.002)
        if side == "jax":
            acc = JaxAccelerator()
            model = JaxLlama("llama-tiny")
            acc.prepare_model(model)
            acc.prepare_optimizer(optax.adamw(1e-3))
            membership = JaxMembershipService(JaxFilesystemStore(str(tmp_path / side), fast), num_hosts=2)
            coordinator = acc.elastic_coordinator(JaxLlama.loss_fn(model), membership=membership,
                                                  config=JaxElasticConfig(redundancy=0, num_hosts=2))
            batch, chaos = {"input_ids": ids}, jax_chaos
        else:
            acc = Accelerator(device="cpu")
            model = Llama("llama-tiny", device="cpu")
            acc.prepare_model(model)
            acc.prepare_optimizer(fused_adamw(1e-3))
            membership = MembershipService(FilesystemStore(str(tmp_path / side), fast), num_hosts=1)
            coordinator = acc.elastic_coordinator(Llama.loss_fn(model), membership=membership,
                                                  config=ElasticConfig(redundancy=0))
            batch, chaos = {"input_ids": ids}, port_chaos
        chaos.activate((JaxFaultPlan if side == "jax" else FaultPlan)(io_failures=10**6))
        try:
            loss = float(coordinator.step(batch))
        finally:
            chaos.deactivate()
        assert np.isfinite(loss)
        ops[side] = [e["op"] for e in membership.events if e["event"] == "store_degraded"]
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    _jax_reset()
    assert ops["port"] == ops["jax"] and ops["port"]


def test_only_a_communication_error_is_taken_for_a_lost_peer():
    """A failed step waits for the detector to name a lost peer only when
    its error is a collective's or the rendezvous's (a backend error, a
    closed or timed-out connection); out of memory, a kernel's failure or
    a shape error is raised where it happened, and a lone process or one
    without a membership store never waits."""
    import torch.distributed as dist

    from accelerate_tpu_torch import ElasticCoordinator, ElasticFailure, StaleEpochError
    from accelerate_tpu_torch.resilience.elastic import HostLost

    coordinator = object.__new__(ElasticCoordinator)
    coordinator.members, coordinator.membership = [0, 1, 2], object()
    lost_peer = [dist.DistBackendError("backend"), dist.DistNetworkError("network"),
                 RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection closed by peer [127.0.0.1]:4321"),
                 RuntimeError("Connection reset by peer"),
                 RuntimeError("Timed out waiting 60000ms for recv operation to complete")]
    other = [RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             RuntimeError("mat1 and mat2 shapes cannot be multiplied (4x8 and 7x8)"),
             RuntimeError("flash_fwd: kernel launch failed: invalid argument"),
             ElasticFailure("timed out"), HostLost("gloo"), StaleEpochError("hosts/1", 1, 2)]
    assert all(coordinator._peer_failure(e) for e in lost_peer)
    assert not any(coordinator._peer_failure(e) for e in other)
    coordinator.members = [0]
    assert not coordinator._peer_failure(lost_peer[0])
    coordinator.members, coordinator.membership = [0, 1], None
    assert not coordinator._peer_failure(lost_peer[2])


def test_a_batch_is_stamped_with_the_generation_its_share_was_cut_for():
    """A regroup that lands between the producer sizing the sampler for
    the live group and cutting the batch leaves the batch stamped with the
    older generation, so ``_remesh_stale`` cuts it again for the new group
    (a newer stamp would let a share of the old group through)."""
    from accelerate_tpu_torch.data_loader import prepare_data_loader
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    state = PartialState(device="cpu")
    rows = np.arange(8 * 2, dtype=np.int64).reshape(8, 2)
    loader = prepare_data_loader([{"x": r} for r in rows], batch_size=4, split_batches=True, prefetch=0,
                                 device="cpu")
    follow = loader._follow_mesh
    before = state.generation

    def follow_then_regroup(generation):
        follow(generation)
        state.generation += 1  # the main thread's rejoin, just after the sampler was sized

    loader._follow_mesh = follow_then_regroup
    try:
        item = next(loader._local_batches())
        assert item.generation == before and state.generation == before + 1
        assert item.rows == [0, 1, 2, 3]
        again = loader._remesh_stale(item, None)
        np.testing.assert_array_equal(again["x"].numpy(), rows[:4])
    finally:
        PartialState._reset_state()
