"""Text processing (the port of ``rten_tpu/text``): HF
tokenizer.json-compatible tokenizers.

The analog of rten-text (rten-text/src/tokenizer.rs): a from-scratch
implementation of the `tokenizer.json` pipeline (normalizer ->
pre-tokenizer -> model -> post-processor -> decoder) with a native C++
encode core, not a binding to the `tokenizers` library, which the tests
use only as a golden.
"""

from .tokenizer import Encoding, Tokenizer, TokenizerError  # noqa: F401
