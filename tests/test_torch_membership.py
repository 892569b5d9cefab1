"""Membership (``resilience/membership.py``): the port's copy against the JAX
package's, pure Python. The same scripted heartbeats (explicit ``now=``),
detections, loss resolutions, joins, admissions, fenced and zombie writes
and mint races run through both packages, over their ``DictStore`` and
their ``FilesystemStore``; the records (without their wall-clock fields),
the views, the epochs and the detections must be equal. No drill thread
of either package is started: the JAX package's elastic drills are not a
steady oracle on this host, so the comparison holds the two on fixed
inputs.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import accelerate_tpu.resilience.chaos as jax_chaos
import accelerate_tpu.resilience.membership as jax_membership
import accelerate_tpu_torch.resilience.chaos as port_chaos
import accelerate_tpu_torch.resilience.membership as port_membership
from accelerate_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from accelerate_tpu_torch.resilience.retry import RetryPolicy as PortRetryPolicy

SIDES = {
    "jax": SimpleNamespace(m=jax_membership, chaos=jax_chaos, retry=JaxRetryPolicy),
    "port": SimpleNamespace(m=port_membership, chaos=port_chaos, retry=PortRetryPolicy),
}
# wall-clock fields (the mint, a join, a supervisor's publication, a flag)
CLOCK = ("time", "minted_at")


def _strip(value):
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in CLOCK}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def _store(side, kind, tmp_path):
    m = SIDES[side].m
    return m.DictStore() if kind == "dict" else m.FilesystemStore(str(tmp_path / side))


def _dump(store, m):
    """Every record of the store, by key, without its clock fields."""
    out = {}
    for prefix in ("hosts", "lost", "join", "stall"):
        out.update(store.list(prefix))
    epoch = store.read(m.EPOCH_KEY)
    if epoch is not None:
        out[m.EPOCH_KEY] = epoch
    return _strip(out)


def _script(side, kind, tmp_path):
    """Three hosts through a loss, a zombie, a re-admission, a supervisor's
    publication, a stall flag and a straggler; every observable along the
    way."""
    m = SIDES[side].m
    store = _store(side, kind, tmp_path)
    config = m.MembershipConfig(heartbeat_timeout_s=5.0, stall_steps_behind=2, stall_timeout_s=5.0)
    svc = [m.MembershipService(store, num_hosts=3, host_index=h, config=config) for h in range(3)]
    log = []
    t = 1000.0
    for step in range(1, 4):  # everyone beats at steps 1-3
        for s in svc:
            log.append(("beat", s.host_index, s.heartbeat(step, now=t + step)))
    log.append(("clean", _strip(svc[0].detect(now=t + 4))))
    for step in range(4, 7):  # host 2 goes silent, host 1 freezes its step-stamp
        log.append(("beat", 0, svc[0].heartbeat(step, now=t + step)))
        log.append(("beat", 1, svc[1].heartbeat(3, now=t + step)))
    log.append(("detect", _strip(svc[0].detect(now=t + 10.5))))
    log.append(("detect_again", _strip(svc[0].detect(now=t + 10.5))))
    log.append(("resolve", svc[0].resolve_loss(2, reason="recovered_buddy")))
    log.append(("adopt", svc[1].resolve_loss(2)))
    log.append(("zombie_beat", svc[2].heartbeat(7, now=t + 11)))
    log.append(("zombie_rejected", svc[2].stale_writes_rejected))
    try:
        store.fenced_write("hosts/2", {"host": 2}, epoch=1)
        log.append(("fenced", "written"))
    except m.StaleEpochError as e:
        log.append(("fenced", e.key, e.stale, e.current))
    log.append(("join", _strip(svc[2].announce_join())))
    log.append(("pending", svc[0].pending_joins()))
    log.append(("admit", svc[0].admit(2)))
    log.append(("admit_again", svc[1].admit(2)))
    log.append(("pending_after", svc[0].pending_joins()))
    log.append(("readmitted_beat", svc[2].heartbeat(8, now=t + 12)))
    log.append(("epoch", [s.epoch for s in svc]))
    m.publish_supervisor_loss(store, 1, reason="exit 137")
    supervisor = svc[0].detect(now=t + 12.5)
    log.append(("supervisor", [(x["host"], x["reason"], x.get("detail")) for x in supervisor]))
    svc[1].report_self_stall(3.25)
    log.append(("stall_seen_by_peer", [(x["host"], x["reason"]) for x in svc[2].detect(now=t + 12.5)]))
    log.append(("stall_not_self", [(x["host"], x["reason"]) for x in svc[1].detect(now=t + 12.5)]))
    svc[1].retract_self_stall()
    log.append(("resolve_supervised", svc[2].resolve_loss(1, reason="supervisor")))
    # the mint race: two minters expecting the same epoch, one wins
    current = store.read(m.EPOCH_KEY)["epoch"]
    store.mint_epoch({"epoch": current + 1, "members": [0, 2]}, expected=current)
    try:
        store.mint_epoch({"epoch": current + 1, "members": [0]}, expected=current)
        log.append(("race", "both"))
    except m.StaleEpochError as e:
        log.append(("race", e.stale, e.current))
    log.append(("view", _strip(svc[0].view())))
    log.append(("store", _dump(store, m)))
    log.append(("events", [_strip(s.events) for s in svc]))
    return log


@pytest.mark.parametrize("kind", ["dict", "filesystem"])
def test_scripted_membership_equals_the_jax_package(kind, tmp_path):
    jax_log = _script("jax", kind, tmp_path)
    port_log = _script("port", kind, tmp_path)
    for want, got in zip(jax_log, port_log):
        assert got == want
    assert len(jax_log) == len(port_log)
    detect = dict((entry[0], entry[1]) for entry in port_log if entry[0] in ("detect", "clean"))
    assert detect["clean"] == []
    assert sorted((x["host"], x["reason"]) for x in detect["detect"]) == [(1, "step_stall"), (2, "heartbeat_silence")]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_mint_race_has_exactly_one_winner(side):
    """``DictStore``'s compare-and-swap: threads minting the same epoch,
    exactly one wins, in both packages."""
    m = SIDES[side].m
    store = m.DictStore()
    store.write(m.EPOCH_KEY, {"epoch": 1, "members": [0, 1, 2]})
    wins, barrier = [], threading.Barrier(8)

    def mint(i):
        barrier.wait()
        try:
            store.mint_epoch({"epoch": 2, "members": [i]}, expected=1)
            wins.append(i)
        except m.StaleEpochError:
            pass

    threads = [threading.Thread(target=mint, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(wins) == 1 and store.read(m.EPOCH_KEY)["members"] == wins


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_hang_watchdog_trips_and_retracts(side, tmp_path):
    """A step blocked past its deadline publishes the stall flag peers
    surface; its completion retracts it; a late trip after the disarm is
    suppressed. The events are the JAX package's."""
    m = SIDES[side].m
    store = m.FilesystemStore(str(tmp_path / side))
    svc = m.MembershipService(store, num_hosts=2, host_index=0)
    peer = m.MembershipService(store, num_hosts=2, host_index=1)
    watchdog = m.CollectiveHangWatchdog(svc, timeout_s=0.05)
    try:
        watchdog.arm()
        deadline = time.monotonic() + 5.0
        while store.read("stall/0") is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [(x["host"], x["reason"]) for x in peer.detect()] == [(0, "collective_hang")]
        watchdog.disarm()
        assert store.read("stall/0") is None and watchdog.trips == 1
        watchdog.arm()
        watchdog.disarm()
        time.sleep(0.15)
        assert watchdog.trips == 1
        assert [e["event"] for e in svc.events] == ["collective_hang_suspected", "collective_hang_cleared"]
    finally:
        watchdog.close()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_store_weather_is_ridden_out_and_config_validated(side, tmp_path):
    """Transient store errors (the chaos plan's I/O leg on
    ``membership_store``) are retried; an out-of-range identity and a probe
    interval at the heartbeat timeout are refused."""
    s = SIDES[side]
    store = s.m.FilesystemStore(str(tmp_path / side), s.retry(max_attempts=4, base_delay=0.001, max_delay=0.002))
    plan = s.chaos.activate(s.chaos.FaultPlan(io_failures=2))
    try:
        svc = s.m.MembershipService(store, num_hosts=2, host_index=1)
        assert svc.heartbeat(1, now=5.0) and store.read("hosts/1")["step"] == 1
    finally:
        s.chaos.deactivate()
    assert [e["fault"] for e in plan.events] == ["io_error", "io_error"]
    with pytest.raises(ValueError, match="out of range"):
        s.m.MembershipService(s.m.DictStore(), num_hosts=2, host_index=2)
    with pytest.raises(ValueError, match="min_probe_interval_s"):
        s.m.MembershipConfig(heartbeat_timeout_s=1.0, min_probe_interval_s=1.0)


def test_from_env_reads_the_membership_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("ACCELERATE_MEMBERSHIP_DIR", raising=False)
    assert port_membership.MembershipService.from_env(num_hosts=2) is None
    monkeypatch.setenv("ACCELERATE_MEMBERSHIP_DIR", str(tmp_path))
    svc = port_membership.MembershipService.from_env(num_hosts=2, host_index=1)
    assert isinstance(svc.store, port_membership.FilesystemStore) and svc.store.root == str(tmp_path)
    assert svc.view()["members"] == [0, 1] and svc.epoch == 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_chaos_membership_legs(side):
    """The plan's silence and stall legs, as the coordinator's heartbeat
    reads them: persistent from their boundary, recorded once."""
    plan = SIDES[side].chaos.FaultPlan(membership_silence_step=3, membership_silence_index=1,
                                       membership_stall_step=4, membership_stall_index=2)
    assert [plan.membership_silent(1, b) for b in (2, 3, 4, 5)] == [False, True, True, True]
    assert not plan.membership_silent(0, 5)
    assert [plan.membership_stall(2, b) for b in (3, 4, 5)] == [None, 3, 3]
    assert [e["fault"] for e in plan.events] == ["membership_silence", "membership_stall"]
