"""Serving: continuous batching over slot-based int8 KV caches."""

from .engine import ContinuousBatchingEngine, QueueFull, Request  # noqa: F401
