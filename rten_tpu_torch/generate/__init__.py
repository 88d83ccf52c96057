"""Autoregressive generation (the port of ``rten_tpu/generate``): the
Generator (KV-cache loop), samplers, logits filters, metrics and the
streaming text decoder."""

from .filter import (  # noqa: F401
    Chain, RepetitionPenalty, Temperature, TopK, TopP, token_id_filter,
)
from .generator import Generator, GeneratorConfig, GeneratorError  # noqa: F401
from .metrics import Metrics  # noqa: F401
from .sampler import (  # noqa: F401
    ArgMaxSampler, DeviceSampler, MultinomialSampler, Sampler,
)
from .text_decoder import TextDecoder  # noqa: F401
