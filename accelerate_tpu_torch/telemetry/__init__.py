"""Serving telemetry of the port."""

from .serving import ServingStats

__all__ = ["ServingStats"]
