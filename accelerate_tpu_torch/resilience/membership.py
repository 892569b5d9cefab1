"""Failure detection and membership: name the lost host, fence the zombie.

Counterpart of ``accelerate_tpu/resilience/membership.py``, pure Python and
the same records: a key to JSON-record store (:class:`MembershipStore`;
:class:`FilesystemStore` over a directory, :class:`DictStore` in memory with
real compare-and-swap), every operation riding :data:`STORE_RETRY` and the
chaos plan's ``probe_io("membership_store")``; heartbeats under
``hosts/<i>`` (a beat counter, the last completed step and the time that
step-stamp last advanced); the detector (:meth:`MembershipService.detect`):
a supervisor's ``lost/<i>``, a self-reported collective hang ``stall/<i>``
(:class:`CollectiveHangWatchdog` around the step), heartbeat silence (the
port's :class:`~.detector.SilenceDetector`) and a step-stamp stall, each
suspicion a ``{"kind": "membership"}`` record with ``mttd_s``; epochs: every
transition (a loss resolved, a host admitted) mints the next epoch naming
the members, and every heartbeat carries its writer's epoch, so a zombie
that slept through a transition cannot write into the new view
(:class:`StaleEpochError`); re-admission through ``join/<i>`` records.

In the port one process is one rank and a host a group of contiguous ranks
(``resilience/elastic.py``): each process publishes only its own host's
beats, and the epoch is also the name of the rendezvous its members form
their next process group at (``PartialState.rejoin``), so a process fenced
out of an epoch can never join that epoch's group.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils.concurrency import named_lock
from ..logging import get_logger
from .chaos import probe_io
from .detector import SilenceDetector
from .retry import RetryPolicy

logger = get_logger(__name__)

# The epoch record's key in the store: {"epoch": n, "members": [...], ...}.
EPOCH_KEY = "epoch"

# Store I/O weather policy: tighter than checkpoint I/O (a heartbeat is tiny
# and frequent — ride a blip out in tens of milliseconds, don't stall the
# step boundary for seconds), same jittered-decorrelation argument.
STORE_RETRY = RetryPolicy(max_attempts=4, base_delay=0.05, max_delay=1.0)


class StaleEpochError(RuntimeError):
    """A store write carried an epoch older than the current membership view
    — the writer is a zombie (fenced out by a transition it slept through).
    The write is REFUSED; the correct next move is :meth:`announce_join`."""

    def __init__(self, key: str, stale: int, current: int):
        super().__init__(
            f"epoch-fenced write to {key!r} refused: writer holds epoch "
            f"{stale}, the membership view is at epoch {current} — the view "
            "moved on while this host was out (announce_join() to re-admit)"
        )
        self.key = key
        self.stale = int(stale)
        self.current = int(current)


class MembershipStore:
    """Rendezvous-store API. Key → small JSON record; keys are
    ``/``-namespaced (``hosts/0``, ``lost/1``, ``join/2``, ``stall/0``,
    ``epoch``). The base class supplies the fenced operations as
    read-check-write over the primitive ``read``/``write`` — a backend with
    transactions (etcd) or generation preconditions (GCS) overrides them
    with a real compare-and-swap and everything above is unchanged."""

    def read(self, key: str) -> Optional[dict]:
        raise NotImplementedError

    def write(self, key: str, payload: dict) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> dict[str, dict]:
        """All records under ``prefix/`` (key → record)."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    # -- fenced operations (backends override with CAS) ---------------------

    def fenced_write(self, key: str, payload: dict, epoch: int) -> None:
        """Refuse the write when the store's epoch has moved past the
        writer's — the zombie fence. Read-check-write here; a distributed
        backend makes the check transactional."""
        current = self.read(EPOCH_KEY)
        if current is not None and int(current.get("epoch", 0)) > int(epoch):
            raise StaleEpochError(key, int(epoch), int(current["epoch"]))
        self.write(key, payload)

    def mint_epoch(self, record: dict, expected: Optional[int]) -> None:
        """Install a new epoch record, refusing when the current epoch is not
        ``expected`` (two survivors racing to resolve the same loss: exactly
        one mint wins; the loser re-reads and finds the work done)."""
        current = self.read(EPOCH_KEY)
        have = int(current.get("epoch", 0)) if current is not None else 0
        if expected is not None and have != int(expected):
            raise StaleEpochError(EPOCH_KEY, int(expected), have)
        self.write(EPOCH_KEY, record)


class FilesystemStore(MembershipStore):
    """Directory-backed store: one JSON file per key, atomic via
    tmp+rename. Correct for CPU drills and single-host jobs; on a
    cluster the directory is typically a GCS-fuse mount, which is exactly the
    I/O weather :data:`STORE_RETRY` and the chaos ``io_failures`` leg
    drill. (A native GCS/etcd backend implements :class:`MembershipStore`
    directly and drops in.)"""

    def __init__(self, root: str, retry_policy: Optional[RetryPolicy] = None):
        self.root = root
        self._retry = retry_policy if retry_policy is not None else STORE_RETRY

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/")) + ".json"

    def _read_op(self, key: str) -> Optional[dict]:
        probe_io("membership_store")
        path = self._path(key)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError:
            # a torn record (rename is atomic, but a dying writer's tmp leak
            # or a flaky mount can surface one) reads as absent, never as
            # fabricated membership state
            return None

    def _write_op(self, key: str, payload: dict) -> None:
        probe_io("membership_store")
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _delete_op(self, key: str) -> None:
        probe_io("membership_store")
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def _list_op(self, prefix: str) -> dict[str, dict]:
        probe_io("membership_store")
        directory = os.path.join(self.root, *prefix.split("/"))
        out: dict[str, dict] = {}
        try:
            names = sorted(os.listdir(directory))
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            key = f"{prefix}/{name[:-5]}"
            record = self._read_op(key)
            if record is not None:
                out[key] = record
        return out

    def read(self, key: str) -> Optional[dict]:
        return self._retry.call(self._read_op, key)

    def write(self, key: str, payload: dict) -> None:
        self._retry.call(self._write_op, key, payload)

    def list(self, prefix: str) -> dict[str, dict]:
        return self._retry.call(self._list_op, prefix)

    def delete(self, key: str) -> None:
        self._retry.call(self._delete_op, key)


class DictStore(MembershipStore):
    """In-memory store with REAL compare-and-swap fenced operations — the
    overridable API shape the ROADMAP's GCS/etcd backend drops into, proven
    here: ``fenced_write`` and ``mint_epoch`` hold one lock across the
    read-check-write, so two racing minters serialize and exactly one wins
    (the base class's unlocked read-check-write only gets that from the
    caller's retry loop; a transactional backend gets it from the store —
    this class IS that contract, minus the network). Records round-trip
    through JSON so a payload that would not survive a real backend
    (non-serializable values, mutation after write) fails here too.

    Process-local by construction: the right backend for single-process
    tests and drills, never for a real multi-host pod."""

    def __init__(self):
        self._data: dict[str, str] = {}
        self._lock = named_lock("membership.store")

    def read(self, key: str) -> Optional[dict]:
        probe_io("membership_store")
        with self._lock:
            raw = self._data.get(key)
        return None if raw is None else json.loads(raw)

    def write(self, key: str, payload: dict) -> None:
        probe_io("membership_store")
        raw = json.dumps(payload)
        with self._lock:
            self._data[key] = raw

    def list(self, prefix: str) -> dict[str, dict]:
        probe_io("membership_store")
        with self._lock:
            items = [
                (k, raw) for k, raw in self._data.items()
                if k.startswith(prefix + "/")
            ]
        return {k: json.loads(raw) for k, raw in sorted(items)}

    def delete(self, key: str) -> None:
        probe_io("membership_store")
        with self._lock:
            self._data.pop(key, None)

    # -- the CAS overrides: read-check-write under ONE lock -----------------

    def fenced_write(self, key: str, payload: dict, epoch: int) -> None:
        probe_io("membership_store")
        raw = json.dumps(payload)
        with self._lock:
            current = self._data.get(EPOCH_KEY)
            if current is not None:
                have = int(json.loads(current).get("epoch", 0))
                if have > int(epoch):
                    raise StaleEpochError(key, int(epoch), have)
            self._data[key] = raw

    def mint_epoch(self, record: dict, expected: Optional[int]) -> None:
        probe_io("membership_store")
        raw = json.dumps(record)
        with self._lock:
            current = self._data.get(EPOCH_KEY)
            have = int(json.loads(current).get("epoch", 0)) if current is not None else 0
            if expected is not None and have != int(expected):
                raise StaleEpochError(EPOCH_KEY, int(expected), have)
            self._data[EPOCH_KEY] = raw


def publish_supervisor_loss(store: "MembershipStore | str", host: int, reason: str = "") -> None:
    """The pod supervisor's side of detection: it always KNEW which worker
    died (exit code or heartbeat silence) and used to throw that away —
    publish it so the survivors' ``request_shrink()`` resolves to a named
    host instead of warning. Accepts a store or a directory path (the
    supervisor runs outside the training process)."""
    if isinstance(store, str):
        store = FilesystemStore(store)
    store.write(
        f"lost/{int(host)}",
        {"host": int(host), "source": "supervisor", "reason": reason, "time": time.time()},
    )


@dataclass(frozen=True)
class MembershipConfig:
    """Detector thresholds: at CPU drill scale tens of milliseconds, on a
    real cluster tens of seconds (a reshard, a kernel build must never read
    as a death).

    - ``heartbeat_timeout_s`` — silence longer than this names the host
      lost (shared :class:`~.detector.SilenceDetector` semantics: strictly
      greater, ``None`` disables).
    - ``stall_steps_behind`` / ``stall_timeout_s`` — a host whose published
      step sits ≥ ``stall_steps_behind`` behind the fleet max AND whose
      step-stamp has not advanced for ``stall_timeout_s`` is wedged in a
      collective (its heartbeats may still flow — liveness of the process
      is not liveness of the rank).
    - ``hang_watchdog_timeout_s`` — arm :class:`CollectiveHangWatchdog`
      around the training step with this deadline (``None`` = off).
    - ``min_probe_interval_s`` — throttle the coordinator's per-boundary
      store work (heartbeats + detection) to at most once per interval.
      0 (default) probes every boundary — right for drills and CPU tests;
      on a pod with sub-second steps and a network-filesystem store, set
      it to a fraction of the detector timeout (e.g. ``timeout/4``) so the
      hot path stops paying fsync'd store I/O per step. Detection latency
      is bounded by ``heartbeat_timeout_s + min_probe_interval_s``; a
      supervisor ``request_shrink()`` always probes immediately regardless.
    """

    heartbeat_timeout_s: Optional[float] = 30.0
    stall_steps_behind: int = 2
    stall_timeout_s: float = 30.0
    hang_watchdog_timeout_s: Optional[float] = None
    min_probe_interval_s: float = 0.0

    def __post_init__(self):
        if (
            self.min_probe_interval_s
            and self.heartbeat_timeout_s is not None  # None = silence leg off
            and self.min_probe_interval_s >= self.heartbeat_timeout_s
        ):
            # peers publish at most once per interval, so at a probing
            # boundary their freshest possible beat is up to interval old —
            # an interval at or past the timeout convicts HEALTHY hosts
            raise ValueError(
                f"min_probe_interval_s ({self.min_probe_interval_s}) must be "
                f"well under heartbeat_timeout_s ({self.heartbeat_timeout_s}) "
                "— peers' beats age up to one interval between probes, so an "
                "interval >= the timeout reads healthy hosts as silent"
            )


class MembershipService:
    """One process's view of the training fleet's membership: publishes its
    heartbeat, detects lost peers, mints epoch-fenced transitions, and
    carries re-admission. The :class:`~.elastic.ElasticCoordinator` drives
    it at step boundaries (``membership=`` probe); each process publishes
    its own host's record."""

    def __init__(
        self,
        store: MembershipStore,
        num_hosts: int,
        host_index: int = 0,
        config: Optional[MembershipConfig] = None,
        telemetry: Any = None,
    ):
        self.store = store
        self.num_hosts = int(num_hosts)
        self.host_index = int(host_index)
        if not 0 <= self.host_index < self.num_hosts:
            # clamping instead would alias several processes onto one
            # membership identity — their interleaved beats mask a real
            # death and fabricate step-stalls
            raise ValueError(
                f"host_index {self.host_index} out of range for "
                f"{self.num_hosts} hosts — one membership identity per host"
            )
        self.config = config or MembershipConfig()
        self.telemetry = telemetry
        self.events: list[dict] = []  # local ledger, mirrors telemetry
        self.stale_writes_rejected = 0
        self._beats: dict[int, int] = {}
        # per published host: (last step value, wall time it last advanced) —
        # the step-stamp the stall detector reads
        self._step_marks: dict[int, tuple[int, float]] = {}
        self._suspected: set[int] = set()
        self._epoch = self._bootstrap_epoch()

    @classmethod
    def from_env(
        cls,
        num_hosts: int,
        host_index: int = 0,
        config: Optional[MembershipConfig] = None,
        telemetry: Any = None,
    ) -> Optional["MembershipService"]:
        """The ``pod-launch --elastic --membership_dir`` transport: the
        launcher exports ``ACCELERATE_MEMBERSHIP_DIR`` to every worker, and
        an unmodified training script's coordinator picks the store up here.
        None when the env var is absent (the common case)."""
        directory = os.environ.get("ACCELERATE_MEMBERSHIP_DIR")
        if not directory:
            return None
        return cls(
            FilesystemStore(directory),
            num_hosts=num_hosts,
            host_index=host_index,
            config=config,
            telemetry=telemetry,
        )

    # -- epoch bookkeeping ---------------------------------------------------

    def _bootstrap_epoch(self) -> int:
        record = self.store.read(EPOCH_KEY)
        if record is None:
            record = {
                "epoch": 1,
                "members": list(range(self.num_hosts)),
                "reason": "bootstrap",
                "minted_at": time.time(),
            }
            # every process bootstraps the same epoch-1 record; last write
            # wins with identical content (a CAS backend makes it first-wins)
            self.store.write(EPOCH_KEY, record)
        return int(record["epoch"])

    @property
    def epoch(self) -> int:
        """The epoch this process believes it is a member of — the fencing
        token its writes carry. Deliberately NOT auto-refreshed from the
        store: a zombie that silently adopted the new epoch would defeat
        the fence. It advances only through a transition this process minted
        (:meth:`resolve_loss` / :meth:`admit`) or a re-admission it earned
        (:meth:`heartbeat` adopting after finding itself in the members
        again)."""
        return self._epoch

    def view(self) -> dict:
        """The store's current membership view (reader op — does not move
        this process's fencing token). ``minted_at`` anchors the silence
        clock for members with no heartbeat record yet (admitted, then died
        before the first beat — without the anchor such a host would be
        invisible to every detector leg)."""
        record = self.store.read(EPOCH_KEY) or {
            "epoch": self._epoch,
            "members": list(range(self.num_hosts)),
        }
        minted_at = record.get("minted_at")
        return {
            "epoch": int(record.get("epoch", self._epoch)),
            "members": [int(m) for m in record.get("members", [])],
            "minted_at": float(minted_at) if minted_at is not None else None,
        }

    def _record(self, event: str, payload: dict) -> dict:
        entry = {"event": event, **payload}
        self.events.append(entry)
        telemetry = self.telemetry
        if telemetry is not None and getattr(telemetry, "enabled", False):
            telemetry.write_record("membership", entry)
        return entry

    # -- heartbeats ----------------------------------------------------------

    def heartbeat(
        self, step: int, host: Optional[int] = None, now: Optional[float] = None
    ) -> bool:
        """Publish one heartbeat: monotonic beat counter, last completed
        ``step``, and the wall time the step-stamp last ADVANCED (what the
        stall detector reads — beats flowing with a frozen step is a wedged
        rank, not a live one). Epoch-fenced: returns False (and records
        ``stale_epoch_write_rejected``) when the view moved on without us —
        unless we were since re-admitted, in which case the new epoch is
        adopted and the beat lands."""
        host = self.host_index if host is None else int(host)
        now = time.time() if now is None else now
        beat = self._beats.get(host, 0) + 1
        prev = self._step_marks.get(host)
        step_time = now if (prev is None or step > prev[0]) else prev[1]
        record = {
            "host": host,
            "beat": beat,
            "step": int(step),
            "time": now,
            "step_time": step_time,
            "epoch": self._epoch,
        }
        try:
            self.store.fenced_write(f"hosts/{host}", record, epoch=self._epoch)
        except StaleEpochError as e:
            adopted = False
            current = self.view()
            if host == self.host_index and host in current["members"]:
                # fenced out, then re-admitted: adopt the new token and beat
                try:
                    self._epoch = current["epoch"]
                    record["epoch"] = self._epoch
                    self.store.fenced_write(f"hosts/{host}", record, epoch=self._epoch)
                    adopted = True
                    self._record(
                        "epoch_adopted", {"host": host, "epoch": self._epoch}
                    )
                except StaleEpochError as e2:
                    # the view moved AGAIN mid-adoption: treat as rejected
                    # (the next beat re-reads and adopts the newest epoch)
                    e = e2
            if not adopted:
                self.stale_writes_rejected += 1
                self._record(
                    "stale_epoch_write_rejected",
                    {"host": host, "stale_epoch": e.stale, "current_epoch": e.current},
                )
                return False
        self._beats[host] = beat
        self._step_marks[host] = (int(step), step_time)
        return True

    # -- the failure detector ------------------------------------------------

    def detect(self, now: Optional[float] = None) -> list[dict]:
        """Named lost-host suspicions, most-certain source first: supervisor
        publication (it watched the process die), a self-reported collective
        hang (the wedged host's own watchdog), heartbeat silence, then the
        step-stamp stall. Each suspicion carries ``reason`` and ``mttd_s``
        (wall time from the failure's last evidence to this detection — the
        metric the bench aggregates). Telemetry records once per host; the
        return value repeats every call until the loss is resolved, so a
        boundary that could not act (mesh infeasible) can act later."""
        now = time.time() if now is None else now
        view = self.view()
        members = view["members"]
        suspicions: list[dict] = []
        named = set()

        def _suspect(host: int, reason: str, mttd: float, **detail):
            if host in named or host not in members:
                return
            named.add(host)
            suspicion = {
                "host": host,
                "reason": reason,
                "mttd_s": round(max(mttd, 0.0), 4),
                **detail,
            }
            suspicions.append(suspicion)
            if host not in self._suspected:
                self._suspected.add(host)
                self._record("host_suspected", suspicion)

        for record in self.store.list("lost").values():
            _suspect(
                int(record["host"]),
                "supervisor",
                now - float(record.get("time", now)),
                detail=record.get("reason"),
            )
        for record in self.store.list("stall").values():
            host = int(record["host"])
            if host == self.host_index:
                continue  # our own flag is for peers, not self-conviction
            _suspect(
                host,
                "collective_hang",
                now - float(record.get("time", now)),
                hang_s=record.get("hang_s"),
            )

        records = {
            h: self.store.read(f"hosts/{h}")
            for h in members
        }
        live = {h: r for h, r in records.items() if r is not None}
        max_step = max((int(r.get("step", 0)) for r in live.values()), default=0)
        silence = SilenceDetector(self.config.heartbeat_timeout_s)
        stall = SilenceDetector(self.config.stall_timeout_s)
        for host in members:
            if records.get(host) is not None:
                continue
            # a member with NO heartbeat record: admitted (or bootstrapped),
            # then died before its first beat. Without an anchor it would be
            # invisible to every leg — the epoch mint time is the last
            # evidence the membership had of it, so silence counts from
            # there.
            anchor = view["minted_at"]
            if anchor is not None and silence.expired(anchor, now):
                _suspect(
                    host,
                    "heartbeat_silence",
                    silence.silent_for(anchor, now),
                    never_beat=True,
                )
        for host, record in live.items():
            last_beat = float(record.get("time", now))
            if silence.expired(last_beat, now):
                _suspect(
                    host,
                    "heartbeat_silence",
                    silence.silent_for(last_beat, now),
                    last_step=record.get("step"),
                )
                continue
            behind = max_step - int(record.get("step", 0))
            step_time = float(record.get("step_time", last_beat))
            if behind >= self.config.stall_steps_behind and stall.expired(step_time, now):
                _suspect(
                    host,
                    "step_stall",
                    stall.silent_for(step_time, now),
                    steps_behind=behind,
                    last_step=record.get("step"),
                )
        return suspicions

    def report_self_stall(self, hang_s: float) -> None:
        """The :class:`CollectiveHangWatchdog` escalation: our own step has
        been blocked past its deadline — publish the stall flag (plain
        write: the wedged host may legitimately be behind the epoch it is
        about to be removed under) so peers' detectors surface US, and say
        so in telemetry."""
        try:
            self.store.write(
                f"stall/{self.host_index}",
                {"host": self.host_index, "hang_s": round(hang_s, 4), "time": time.time()},
            )
        except Exception as e:  # noqa: BLE001 - a side thread must not crash the run
            logger.warning(f"membership: could not publish stall flag: {e}")
        self._record(
            "collective_hang_suspected",
            {"host": self.host_index, "hang_s": round(hang_s, 4)},
        )

    def retract_self_stall(self) -> None:
        """The wedge cleared — the armed step COMPLETED after tripping the
        watchdog (a slow compile, a straggler window), so the stall flag
        must come down or peers would convict a merely-slow host forever.
        A genuinely hung step never reaches the disarm that calls this, so
        the flag stays up exactly as long as the wedge does."""
        try:
            self.store.delete(f"stall/{self.host_index}")
        except Exception as e:  # noqa: BLE001 - tidying must not fail the step
            logger.warning(f"membership: could not retract stall flag: {e}")
            return
        self._record("collective_hang_cleared", {"host": self.host_index})

    # -- membership transitions (epoch mints) --------------------------------

    def resolve_loss(self, host: int, reason: str = "detected") -> int:
        """The loss of ``host`` is being acted on (the elastic ladder ran):
        mint the next epoch WITHOUT it, fencing out any write the dead host
        might still attempt, and clear its detection artifacts.

        Race-safe: when several survivors resolve the same loss, exactly one
        mint wins (the CAS shape) — the losers re-read, find the host
        already removed, and ADOPT the winner's epoch instead of erroring
        out of an otherwise-successful recovery."""
        host = int(host)
        for _ in range(4):
            current = self.view()
            if host not in current["members"]:
                # a peer already minted this transition: the work is done
                self._epoch = max(self._epoch, current["epoch"])
                self._suspected.discard(host)
                self._record(
                    "epoch_adopted",
                    {"host": self.host_index, "epoch": self._epoch, "removed": host},
                )
                return self._epoch
            members = sorted(set(current["members"]) - {host})
            new_epoch = current["epoch"] + 1
            try:
                self.store.mint_epoch(
                    {
                        "epoch": new_epoch,
                        "members": members,
                        "reason": reason,
                        "removed": host,
                        "minted_at": time.time(),
                    },
                    expected=current["epoch"],
                )
            except StaleEpochError:
                continue  # the epoch moved under us: re-read and retry/adopt
            self._epoch = new_epoch
            for key in (f"lost/{host}", f"stall/{host}"):
                self.store.delete(key)
            self._suspected.discard(host)
            self._record(
                "epoch_minted",
                {"epoch": new_epoch, "members": members, "removed": host, "reason": reason},
            )
            return new_epoch
        raise StaleEpochError(EPOCH_KEY, self._epoch, self.view()["epoch"])

    def announce_join(self, host: Optional[int] = None) -> dict:
        """A revived host asks back in: write the join record survivors pick
        up at their next step boundary. Deliberately not epoch-fenced — the
        joiner is by definition behind the current epoch; it reads the view
        first and says which epoch it saw."""
        host = self.host_index if host is None else int(host)
        current = self.view()
        record = {"host": host, "time": time.time(), "epoch_seen": current["epoch"]}
        self.store.write(f"join/{host}", record)
        self._record("join_announced", {"host": host, "epoch_seen": current["epoch"]})
        return record

    def pending_joins(self) -> list[int]:
        """Hosts with a join record awaiting admission (survivor-side)."""
        return sorted(
            int(record["host"]) for record in self.store.list("join").values()
        )

    def admit(self, host: int) -> int:
        """A survivor admits a joined host: mint the next epoch WITH it and
        clear its join record and any stale artifacts (including its old
        heartbeat record — a pre-death beat time would instantly re-read as
        silence). The joiner's next heartbeat adopts the new epoch.
        Race-safe like :meth:`resolve_loss`: a losing minter adopts the
        winner's epoch."""
        host = int(host)
        for _ in range(4):
            current = self.view()
            if host in current["members"]:
                # a peer already admitted it: adopt and tidy the join record
                self._epoch = max(self._epoch, current["epoch"])
                self.store.delete(f"join/{host}")
                self._suspected.discard(host)
                return self._epoch
            members = sorted(set(current["members"]) | {host})
            new_epoch = current["epoch"] + 1
            try:
                self.store.mint_epoch(
                    {
                        "epoch": new_epoch,
                        "members": members,
                        "reason": "admitted",
                        "admitted": host,
                        "minted_at": time.time(),
                    },
                    expected=current["epoch"],
                )
            except StaleEpochError:
                continue  # the epoch moved under us: re-read and retry/adopt
            self._epoch = new_epoch
            for key in (f"join/{host}", f"hosts/{host}", f"lost/{host}", f"stall/{host}"):
                self.store.delete(key)
            self._step_marks.pop(host, None)
            self._suspected.discard(host)
            self._record(
                "host_admitted", {"host": host, "epoch": new_epoch, "members": members}
            )
            return new_epoch
        raise StaleEpochError(EPOCH_KEY, self._epoch, self.view()["epoch"])


class CollectiveHangWatchdog:
    """The training-side hang watchdog, riding the serving
    :class:`~..serving.engine.StepWatchdog` seam: a deadline armed around
    every compiled step, watched from a side thread — a rank wedged inside a
    collective blocks the host thread that would report it, so the report
    must come from the side. On a trip the membership service publishes the
    stall flag (peers' detectors turn it into a named loss) and records
    ``collective_hang_suspected``. One trip per armed step, idle otherwise —
    the exact discipline the serving engine already proved."""

    def __init__(self, membership: MembershipService, timeout_s: float):
        from ..serving.engine import StepWatchdog

        self.membership = membership
        self.timeout_s = float(timeout_s)
        self.trips = 0
        # publish/retract are serialized under this lock so a watchdog
        # thread firing RIGHT at the disarm boundary can never strand an
        # orphaned stall flag: either it publishes before disarm (which
        # then retracts) or disarm wins and the late trip is suppressed
        self._lock = named_lock("membership.watchdog")
        self._armed = False
        self._published = False
        self._watchdog = StepWatchdog(self.timeout_s, self._on_hang)

    def _on_hang(self, seconds: float) -> None:
        with self._lock:
            if not self._armed:
                return  # the step already completed: a late trip is moot
            self.trips += 1
            self._published = True
            self.membership.report_self_stall(seconds)

    def arm(self) -> None:
        with self._lock:
            self._armed = True
            self._published = False
        self._watchdog.arm()

    def disarm(self) -> None:
        """The step completed: stand down — and if the watchdog tripped
        during this step, RETRACT the published stall flag (the step
        finished, so the host is slow, not dead; leaving the flag up would
        let peers reshard out a healthy rank). A truly wedged step never
        reaches this disarm, so a real hang keeps its flag."""
        self._watchdog.disarm()
        with self._lock:
            self._armed = False
            published, self._published = self._published, False
        if published:
            self.membership.retract_self_stall()

    def close(self) -> None:
        self._watchdog.close()
