"""Autoregressive generation helpers: the samplers."""

from .sampler import ArgMaxSampler, Sampler  # noqa: F401
