"""Resilience of the port: the retry policy that checkpoint I/O and the data
loader ride. Guards, chaos, the failure detector, membership and elastic
training come with ROADMAP item 18."""

from .retry import DEFAULT_IO_RETRY, RetryPolicy

__all__ = ["DEFAULT_IO_RETRY", "RetryPolicy"]
