"""Seeded Whisper weights under the Hugging Face names, made with numpy.

``random_weights(cfg, seed)`` gives the dict of numpy arrays that
``WhisperForConditionalGeneration(...).state_dict()`` holds (the same
names and shapes; ``tests/test_torch_whisper.py`` checks them against
``transformers`` at two widths), for any ``WhisperConfig`` of either
package. Both packages' ``whisper.WhisperModel`` load it, and the smoke
test on the card imports it, where ``transformers`` is not installed.

The values follow Whisper's initialization (normal, std 0.02, for the
projections, convolutions and embeddings), with small random biases and
layer-norm parameters near (1, 0) so that every term of the graph takes
part; ``sharpen`` multiplies the attention and MLP projections, as the
other full-width phases do, so that greedy tokens depend on the context.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def hf_config_kwargs(cfg, ffn_dim: Optional[int] = None) -> dict:
    """The keyword arguments of ``transformers.WhisperConfig`` for ``cfg``."""
    ffn = ffn_dim or 4 * cfg.d_model
    return dict(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.n_mels, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.heads, decoder_attention_heads=cfg.heads,
        encoder_ffn_dim=ffn, decoder_ffn_dim=ffn,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        suppress_tokens=[], begin_suppress_tokens=[],
    )


def weight_specs(cfg, ffn_dim: Optional[int] = None) -> Dict[str, Tuple[tuple, str]]:
    """Each weight's shape and kind, by its Hugging Face name: ``proj``
    (an attention or MLP projection), ``bias``, ``normal`` (convolutions
    and embeddings), ``ln_weight``, ``ln_bias``, ``sinusoids`` (the
    encoder's fixed positions) or ``tied`` (proj_out, the token
    embedding)."""
    E, ffn = cfg.d_model, ffn_dim or 4 * cfg.d_model
    specs: Dict[str, Tuple[tuple, str]] = {}

    def linear(prefix, n_out, n_in, bias=True):
        specs[f"{prefix}.weight"] = ((n_out, n_in), "proj")
        if bias:
            specs[f"{prefix}.bias"] = ((n_out,), "bias")

    def norm(prefix):
        specs[f"{prefix}.weight"] = ((E,), "ln_weight")
        specs[f"{prefix}.bias"] = ((E,), "ln_bias")

    def attention(prefix):
        linear(f"{prefix}.k_proj", E, E, bias=False)
        linear(f"{prefix}.v_proj", E, E)
        linear(f"{prefix}.q_proj", E, E)
        linear(f"{prefix}.out_proj", E, E)

    def block(prefix, cross):
        attention(f"{prefix}.self_attn")
        norm(f"{prefix}.self_attn_layer_norm")
        if cross:
            attention(f"{prefix}.encoder_attn")
            norm(f"{prefix}.encoder_attn_layer_norm")
        linear(f"{prefix}.fc1", ffn, E)
        linear(f"{prefix}.fc2", E, ffn)
        norm(f"{prefix}.final_layer_norm")

    specs["model.encoder.conv1.weight"] = ((E, cfg.n_mels, 3), "normal")
    specs["model.encoder.conv1.bias"] = ((E,), "bias")
    specs["model.encoder.conv2.weight"] = ((E, E, 3), "normal")
    specs["model.encoder.conv2.bias"] = ((E,), "bias")
    specs["model.encoder.embed_positions.weight"] = ((cfg.max_source_positions, E), "sinusoids")
    for i in range(cfg.encoder_layers):
        block(f"model.encoder.layers.{i}", cross=False)
    norm("model.encoder.layer_norm")
    specs["model.decoder.embed_tokens.weight"] = ((cfg.vocab_size, E), "normal")
    specs["model.decoder.embed_positions.weight"] = ((cfg.max_target_positions, E), "normal")
    for i in range(cfg.decoder_layers):
        block(f"model.decoder.layers.{i}", cross=True)
    norm("model.decoder.layer_norm")
    specs["proj_out.weight"] = ((cfg.vocab_size, E), "tied")
    return specs


def random_weights(cfg, seed: int = 0, sharpen: float = 1.0,
                   ffn_dim: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Whisper's state_dict for ``cfg`` from ``seed`` (float32 numpy)."""
    rng = np.random.default_rng(seed)
    w: Dict[str, np.ndarray] = {}
    for name, (shape, kind) in weight_specs(cfg, ffn_dim).items():
        if kind == "sinusoids":
            w[name] = _sinusoids(*shape)
        elif kind == "tied":  # as in the HF model
            w[name] = w["model.decoder.embed_tokens.weight"]
        else:
            x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            w[name] = (x * np.float32(sharpen) if kind == "proj"
                       else x + np.float32(1.0) if kind == "ln_weight" else x)
    return w
