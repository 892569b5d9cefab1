"""The KV handoff's transfer leg of the redistribution primitive.

Counterpart of the paged-transfer part of
``accelerate_tpu/parallel/redistribute.py``: :func:`paged_transfer`, the
stage failure it raises and the process-wide transfer sequence the chaos
plan's ``redistribute_fail_*`` legs index. The rest of that module (the
planned, staged and host-relay redistribution of a sharded tree and its
epoch fence) comes with ROADMAP item 17(e).

A parked request's KV lives in fixed-shape pages, so the handoff moves
``len(pages)`` page blocks: one stage per page, the page being the chunk.
The source engine's ``extract_pages`` copies them to the host in one
gather and one copy per pool, and the destination's ``adopt_kv`` copies
them up: the host relay, one device-to-host and one host-to-device copy a
handoff and no synchronization beyond the device-to-host copy's own. The
commit (adoption and the source's ``release_parked``) stays with the
router, whose retry-then-re-prefill ladder is this transfer's fallback.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class RedistributeError(RuntimeError):
    """A redistribution that could not complete; the message names the
    failing stage."""


class RedistributeStageFailure(RedistributeError):
    """One stage died mid-transfer (chaos, or a real copy failure). The
    source is intact: the caller decides the fallback."""

    def __init__(self, message: str, *, stage: int, kind: str, leaf: str):
        super().__init__(message)
        self.stage = int(stage)
        self.kind = kind
        self.leaf = leaf


_SEQ_LOCK = threading.Lock()
_TRANSFER_SEQ = 0


def _next_seq() -> int:
    global _TRANSFER_SEQ
    with _SEQ_LOCK:
        seq = _TRANSFER_SEQ
        _TRANSFER_SEQ += 1
        return seq


def reset_transfer_seq() -> None:
    """Re-zero the process-wide transfer counter the chaos leg indexes."""
    global _TRANSFER_SEQ
    with _SEQ_LOCK:
        _TRANSFER_SEQ = 0


def paged_transfer(
    extract: Callable[[list], tuple],
    pages: list,
    *,
    fault_plan: Any = None,
    probe: Optional[Callable[[], None]] = None,
    telemetry: Any = None,
    trace_id: Optional[str] = None,
) -> tuple:
    """Move ``pages``' K and V blocks through ``extract`` (the source
    engine's ``extract_pages``) and return them: one stage per page.

    The chaos plan's ``redistribute_fail`` legs kill a named page-read
    stage here (:class:`RedistributeStageFailure`), and ``probe`` (the
    router's handoff stall/loss window) fires between deciding to move and
    the read. With a telemetry sink whose ``enabled`` is true, one
    ``{"kind": "redistribute"}`` record describes the transfer."""
    from ..resilience import chaos as chaos_mod

    if fault_plan is None:
        fault_plan = chaos_mod.active_plan()
    seq = _next_seq()
    t0 = time.perf_counter()
    n = len(pages)
    if fault_plan is not None:
        for stage in range(n):
            if fault_plan.redistribute_fail(seq, stage, "paged_extract"):
                raise RedistributeStageFailure(
                    f"redistribute transfer {seq} lost page-read stage {stage} of {n} mid-transfer",
                    stage=stage, kind="paged_extract", leaf=f"page[{stage}]",
                )
    if probe is not None:
        probe()
    k_blocks, v_blocks = extract(pages)
    moved = int(k_blocks.nbytes + v_blocks.nbytes)
    if telemetry is not None and getattr(telemetry, "enabled", False):
        payload = {
            "transfer": seq,
            "path": "host_relay",
            "leaves": 2,
            "stages": n,
            "stage_kinds": {"paged_extract": n},
            "bytes_moved": moved,
            "peak_scratch_bytes": moved // max(n, 1),
            "max_scratch_bytes": moved // max(n, 1),
            "outcome": "committed",
            "wall_time_s": time.perf_counter() - t0,
        }
        if trace_id is not None:
            payload["trace_id"] = trace_id
        telemetry.write_record("redistribute", payload)
    return k_blocks, v_blocks
