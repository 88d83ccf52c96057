"""Model zoo: architectures built directly in the engine IR."""

from . import gpt2, llama, mnist, moe, whisper  # noqa: F401
