"""Model zoo: architectures built directly in the engine IR."""

from . import gpt2, llama  # noqa: F401
