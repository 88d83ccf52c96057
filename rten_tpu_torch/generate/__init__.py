"""Autoregressive generation (the port of ``rten_tpu/generate``): the
Generator (KV-cache loop), samplers, logits filters and metrics."""

from .filter import (  # noqa: F401
    Chain, RepetitionPenalty, Temperature, TopK, TopP, token_id_filter,
)
from .generator import Generator, GeneratorConfig, GeneratorError  # noqa: F401
from .metrics import Metrics  # noqa: F401
from .sampler import ArgMaxSampler, MultinomialSampler, Sampler  # noqa: F401
