"""Retry policy: jittered exponential backoff over a transient-error
classifier.

Counterpart of ``accelerate_tpu/resilience/retry.py``: ``RetryPolicy`` and
``DEFAULT_IO_RETRY``, which the data loader's batch fetch and the
checkpoint commit protocol ride, and the serving fleet's classifiers and
policies (``is_fleet_transient``/``FLEET_RETRY`` for placement,
``is_handoff_transient``/``HANDOFF_RETRY`` for the live-KV handoff).

Every backoff is reported through :data:`retry_hook` (``_notify``), the
seam the resilience hub points at its telemetry sink (``hub.py``).
"""

from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

# called as hook(op, attempt, delay_s, exception) before each backoff sleep;
# it must never break the retried operation
retry_hook: Optional[Callable[[str, int, float, Exception], None]] = None


def _notify(op: str, attempt: int, delay: float, error: Exception) -> None:
    hook = retry_hook
    if hook is None:
        return
    try:
        hook(op, attempt, delay, error)
    except Exception:  # noqa: BLE001 - observers must never fail the retry
        pass


def _default_classify(exception: Exception) -> bool:
    from ..utils.memory import is_transient_io_error

    return is_transient_io_error(exception)


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry, how long to wait, and what counts as retryable.

    ``delay(attempt)`` for the attempt that just failed (0-based) is
    ``min(base_delay * 2**attempt, max_delay)`` scaled by a uniform
    ``1 ± jitter`` factor. ``classify=None`` uses
    ``utils.memory.is_transient_io_error``; ``sleep`` is injectable for
    tests.
    """

    max_attempts: int = 4
    base_delay: float = 0.5
    max_delay: float = 8.0
    jitter: float = 0.25
    classify: Optional[Callable[[Exception], bool]] = None
    sleep: Callable[[float], None] = time.sleep

    def delay_for(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        delay = min(self.base_delay * (2**attempt), self.max_delay)
        if self.jitter:
            draw = (rng or random).random()
            delay *= 1.0 + self.jitter * (2.0 * draw - 1.0)
        return max(delay, 0.0)

    def call(self, function: Callable, *args, **kwargs):
        """Run ``function(*args, **kwargs)``, retrying failures the
        classifier calls transient. Other errors, and the last attempt's,
        propagate unchanged."""
        classify = self.classify or _default_classify
        op = getattr(function, "__name__", None) or "call"
        for attempt in range(self.max_attempts):
            try:
                return function(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - the classifier decides
                if attempt == self.max_attempts - 1 or not classify(e):
                    raise
                delay = self.delay_for(attempt)
                _notify(op, attempt + 1, delay, e)
                self.sleep(delay)

    def wrap(self, function: Optional[Callable] = None):
        """Decorator form of :meth:`call` (bare or parameterized)."""
        if function is None:
            return self.wrap

        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            return self.call(function, *args, **kwargs)

        return wrapper


# the default for file I/O: the checkpoint commit protocol and the data
# loader's batch fetch
DEFAULT_IO_RETRY = RetryPolicy()


def is_fleet_transient(exception: Exception) -> bool:
    """The serving fleet's weather: a lost replica
    (:class:`~..serving.fleet.ReplicaLost`) and a full queue
    (:class:`~..serving.scheduler.QueueFull`) are ridden out by a re-home or
    a backoff (the request is fine, its placement failed). Anything else
    goes to the I/O classifier, so a malformed request (``ValueError``)
    fails fast instead of bouncing around the fleet."""
    from ..serving.fleet import ReplicaLost
    from ..serving.scheduler import QueueFull

    if isinstance(exception, (ReplicaLost, QueueFull)):
        return True
    return _default_classify(exception)


# placement retries: a fleet re-offer happens once per router step, so the
# backoff only paces callers that retry outside the step loop
FLEET_RETRY = RetryPolicy(
    max_attempts=6, base_delay=0.05, max_delay=2.0, classify=is_fleet_transient
)


def is_handoff_transient(exception: Exception) -> bool:
    """The live-KV handoff's weather: a transfer that timed out or lost its
    source (:class:`~..serving.fleet.HandoffLost`), a destination with no
    free lane or pages (``QueueFull``) and a replica dying under the attempt
    (``ReplicaLost``) are transient: the parked pages stay referenced at the
    source, so a later attempt reads the same bits. A ``ValueError`` (the
    pools' page geometry differs) ends the handoff, never the request: the
    router re-prefills on the decode pool.

    The router spends no retry budget on ``QueueFull``: it defers the
    handoff to the next fleet step, since only stepping frees a pool."""
    from ..serving.fleet import HandoffLost, ReplicaLost
    from ..serving.scheduler import QueueFull

    if isinstance(exception, (HandoffLost, ReplicaLost, QueueFull)):
        return True
    return _default_classify(exception)


# handoff retries run inside a router step while the source's pages stay
# parked: short jittered backoffs, then the fallback to re-prefill
HANDOFF_RETRY = RetryPolicy(
    max_attempts=3, base_delay=0.01, max_delay=0.2, classify=is_handoff_transient
)
