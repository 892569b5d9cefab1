"""The wall-clock silence primitive: "is this thing still alive?" decided
from the absence of evidence.

Counterpart of ``accelerate_tpu/resilience/detector.py``. The serving
fleet's replica heartbeat (``serving/fleet.py``) and the training
membership detector (``resilience/membership.py``) decide with it.

Semantics:

- silence is strictly more than ``timeout_s`` since ``last_seen`` (exactly
  ``timeout_s`` is still alive);
- ``timeout_s=None`` disables the detector (never silent), the fleet's
  default: an in-process fleet steps synchronously;
- the caller owns the clock: ``last_seen`` and ``now`` come from the same
  one, and the default ``now`` is ``time.monotonic()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SilenceDetector:
    """Declares silence when more than ``timeout_s`` passed since the last
    evidence of life. ``None`` disables it (never silent)."""

    timeout_s: Optional[float] = None

    def silent_for(self, last_seen: float, now: Optional[float] = None) -> float:
        """Seconds since the last evidence of life."""
        return (time.monotonic() if now is None else now) - last_seen

    def expired(self, last_seen: float, now: Optional[float] = None) -> bool:
        """True when the silence exceeds the timeout, strictly."""
        if self.timeout_s is None:
            return False
        return self.silent_for(last_seen, now) > self.timeout_s
