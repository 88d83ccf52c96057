"""Serving: continuous batching over slot-based KV caches, speculative
decoding and an HTTP front end (the port of ``rten_tpu/serving``)."""

from .engine import ContinuousBatchingEngine, QueueFull, Request  # noqa: F401
from .speculative import SpeculativeEngine  # noqa: F401
