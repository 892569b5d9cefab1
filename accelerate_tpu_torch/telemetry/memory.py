"""Device memory watermarks + host RSS.

Counterpart of ``accelerate_tpu/telemetry/memory.py``. Polled on the
step-timer's sampling cadence (never per step): each sample reads the
caching allocator's ``torch.cuda.memory_stats()`` of this process's card and
folds it into run-lifetime watermarks. Two peak notions are kept
deliberately distinct:

- ``peak_bytes_in_use``: the allocator's OWN high watermark
  (``allocated_bytes.all.peak``) — catches spikes between polls;
- ``observed_high_bytes``: the max of the *sampled* live bytes
  (``allocated_bytes.all.current``) — what the steady state actually holds.

``bytes_limit`` is the card's total memory. Reading the allocator's
counters is a host-side read: it launches nothing and waits for nothing.
CPU runs expose no device stats (the watermark is None); the host RSS
watermark is reported instead, so ``telemetry.jsonl`` always carries a real
memory signal.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..utils.environment import get_device_memory_info, get_host_memory_info
from ..utils.params import state_leaves


def state_bytes_per_chip(tree: Any) -> int:
    """Bytes of a state tree THIS process holds: the tensors it was given,
    which under the ZeRO sharded update are its 1/N shards, not the whole
    logical state (the saving is then a telemetry number,
    ``opt_state_bytes_per_chip``, not a claim). Host-offloaded leaves count
    too: they are this process's state wherever they live."""
    return sum(int(x.numel()) * x.element_size() for x in state_leaves(tree) if isinstance(x, torch.Tensor))


class MemoryMonitor:
    def __init__(self):
        self.samples = 0
        self._per_device: list[dict] = []  # watermarks, index-aligned with the devices read
        self._host: dict = {}

    def sample(self) -> None:
        self.samples += 1
        for i, info in enumerate(get_device_memory_info()):
            if i >= len(self._per_device):
                self._per_device.append(
                    {
                        "bytes_limit": info["bytes_limit"],
                        "live_bytes": info["bytes_in_use"],
                        "observed_high_bytes": info["bytes_in_use"],
                        "peak_bytes_in_use": info["peak_bytes_in_use"],
                    }
                )
                continue
            mark = self._per_device[i]
            mark["bytes_limit"] = info["bytes_limit"]
            mark["live_bytes"] = info["bytes_in_use"]
            mark["observed_high_bytes"] = max(mark["observed_high_bytes"], info["bytes_in_use"])
            mark["peak_bytes_in_use"] = max(mark["peak_bytes_in_use"], info["peak_bytes_in_use"])
        host = get_host_memory_info()
        if host:
            prev_peak = self._host.get("peak_rss_bytes", 0)
            self._host = {**host, "peak_rss_bytes": max(host["peak_rss_bytes"], prev_peak)}

    @property
    def hbm_high_watermark_bytes(self) -> Optional[int]:
        if not self._per_device:
            return None
        return max(d["peak_bytes_in_use"] for d in self._per_device)

    def snapshot(self) -> dict:
        out: dict = {"samples": self.samples}
        if self._per_device:
            out["devices"] = [dict(d) for d in self._per_device]
            out["hbm_high_watermark_bytes"] = self.hbm_high_watermark_bytes
            out["hbm_limit_bytes"] = max(d["bytes_limit"] for d in self._per_device)
        if self._host:
            out["host_rss_bytes"] = self._host.get("rss_bytes")
            out["host_peak_rss_bytes"] = self._host.get("peak_rss_bytes")
        return out
