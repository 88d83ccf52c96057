"""Whisper encoder-decoder built in the engine IR (the port of
``rten_tpu/models/whisper.py``).

The reference's whisper example flow (rten-examples/src/whisper.rs driven
by rten-generate with cross-attention caches), as three graphs:

* encoder: mel [B, n_mels, T] -> conv stack -> transformer -> hidden states
  (its self-attention is the ``Attention`` op, which runs the ``mha``
  kernel on the card: Tq >= 8, no mask);
* cross_kv: encoder states -> per-layer cross-attention K/V, computed once
  an audio segment (rten generator.rs:891-915);
* decoder: tokens + self-attention KV cache (growing, Generator-managed) +
  frozen cross K/V inputs -> logits + present.N.decoder.{key,value}.

``build_mel_frontend`` is the log-mel spectrogram as a graph (STFT, the
filterbank product), so the audio front end runs on the model's device;
``log_mel_spectrogram`` is the same in numpy on the host. Weights map 1:1
from Hugging Face ``WhisperForConditionalGeneration.state_dict()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph
from ..model import Model, ModelOptions


@dataclasses.dataclass
class WhisperConfig:
    """Whisper-tiny's published widths by default."""

    vocab_size: int = 51865
    n_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 6
    max_source_positions: int = 1500
    max_target_positions: int = 448

    @property
    def head_dim(self):
        return self.d_model // self.heads


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def log_mel_spectrogram(
    audio: np.ndarray,
    n_mels: int = 80,
    n_fft: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
) -> np.ndarray:
    """Whisper's mel front end on the host (openai/whisper's audio.py
    math): audio [T] -> [n_mels, frames]."""
    audio = np.asarray(audio, np.float32)
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    padded = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = padded[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [frames, bins]
    mel_fb = _mel_filterbank(sample_rate, n_fft, n_mels)
    mel = mel_fb @ spec[:-1].T  # whisper drops the last frame
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-style mel filterbank (librosa-compatible)."""
    fmax = sr / 2
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, fmax, n_bins)

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / 66.6666666
        log_region = f >= 1000.0
        return np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / np.log(6.4) * 27.0, mel
        )

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        hz = m * 66.6666666
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), hz)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    pts = mel_to_hz(mels)
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, center, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / max(center - lo, 1e-9)
        down = (hi - freqs) / max(hi - center, 1e-9)
        fb[i] = np.maximum(0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # Slaney normalization
    return fb.astype(np.float32)


def build_mel_frontend(
    n_samples: int,
    n_mels: int = 80,
    n_fft: int = 400,
    hop: int = 160,
    sample_rate: int = 16000,
) -> Graph:
    """The log-mel spectrogram as a graph (the STFT op, then the filterbank
    product): audio [B, n_samples] -> mel [B, n_mels, frames], numerically
    ``log_mel_spectrogram`` (rten's STFT-op whisper path, src/ops/fft.rs:137)."""
    b = GraphBuilder()
    audio = b.input("audio", DataType.Float, ("batch", n_samples))
    pad = n_fft // 2
    pads = b.constant(None, np.int32([0, pad, 0, pad]))
    padded = b.op("Pad", [audio, pads], {"mode": "reflect"})
    window = b.constant("hann", np.hanning(n_fft + 1)[:-1].astype(np.float32))
    step = b.constant(None, np.int32(hop))
    spec_ri = b.op("STFT", [padded, step, window], {"onesided": 1})
    # power spectrum |z|^2 = re^2 + im^2
    re = b.op("Gather", [spec_ri, b.constant(None, np.int32(0))], {"axis": -1})
    im = b.op("Gather", [spec_ri, b.constant(None, np.int32(1))], {"axis": -1})
    power = b.op("Add", [b.op("Mul", [re, re]), b.op("Mul", [im, im])])
    # drop the last frame (whisper's convention): [B, F - 1, bins]
    n_frames = 1 + (n_samples + 2 * pad - n_fft) // hop
    power = b.op("Slice", [power, b.constant(None, np.int32([0])),
                           b.constant(None, np.int32([n_frames - 1])),
                           b.constant(None, np.int32([1]))])
    fb = b.constant(
        "mel_fb", np.ascontiguousarray(_mel_filterbank(sample_rate, n_fft, n_mels).T)
    )  # [bins, n_mels]
    mel = b.op("MatMul", [power, fb])  # [B, F - 1, n_mels]
    mel = b.op("Transpose", [mel], {"perm": [0, 2, 1]})  # [B, n_mels, F - 1]
    floor = b.constant(None, np.float32(1e-10))
    ln10 = b.constant(None, np.float32(1.0 / np.log(10.0)))
    log_spec = b.op("Mul", [b.op("Log", [b.op("Max", [mel, floor])]), ln10])
    # clamp to (the global max - 8)
    gmax = b.op("ReduceMax", [log_spec], {"axes": [1, 2], "keepdims": 1})
    eight = b.constant(None, np.float32(8.0))
    log_spec = b.op("Max", [log_spec, b.op("Sub", [gmax, eight])])
    four = b.constant(None, np.float32(4.0))
    b.output(b.op("Div", [b.op("Add", [log_spec, four]), four], output_names=["mel"]))
    return b.finish()


class _Layers:
    """The builder helpers the three graphs share."""

    def __init__(self, b: GraphBuilder, cfg: WhisperConfig, w: Dict[str, np.ndarray]):
        self.b, self.cfg, self.w = b, cfg, w

    def c(self, name):
        return self.b.constant(name, np.ascontiguousarray(self.w[name], np.float32))

    def ln(self, h, prefix, **kw):
        return self.b.op(
            "LayerNormalization", [h, self.c(f"{prefix}.weight"), self.c(f"{prefix}.bias")], **kw
        )

    def linear(self, h, prefix, bias=True):
        wt = self.b.constant(
            f"{prefix}.weight_t",
            np.ascontiguousarray(self.w[f"{prefix}.weight"].T, np.float32),
        )
        if bias and f"{prefix}.bias" in self.w:
            return self.b.op("MatMulAdd", [h, wt, self.c(f"{prefix}.bias")], name=prefix)
        return self.b.op("MatMul", [h, wt], name=prefix)

    def heads_of(self, h, **kw):
        H, D = self.cfg.heads, self.cfg.head_dim
        r = self.b.op("Reshape", [h, self.b.constant(None, np.int32([0, 0, H, D]))])
        return self.b.op("Transpose", [r], {"perm": [0, 2, 1, 3]}, **kw)

    def merge(self, h):
        r = self.b.op("Transpose", [h], {"perm": [0, 2, 1, 3]})
        return self.b.op("Reshape", [r, self.b.constant(None, np.int32([0, 0, self.cfg.d_model]))])


def build_encoder(cfg: WhisperConfig, w: Dict[str, np.ndarray]) -> Graph:
    b = GraphBuilder()
    L = _Layers(b, cfg, w)
    mel = b.input("mel", DataType.Float, ("batch", cfg.n_mels, "frames"))
    x = b.op("Conv", [mel, L.c("model.encoder.conv1.weight"), L.c("model.encoder.conv1.bias")],
             {"pads": [1, 1], "strides": [1]})
    x = b.op("Gelu", [x])
    x = b.op("Conv", [x, L.c("model.encoder.conv2.weight"), L.c("model.encoder.conv2.bias")],
             {"pads": [1, 1], "strides": [2]})
    x = b.op("Gelu", [x])
    x = b.op("Transpose", [x], {"perm": [0, 2, 1]})  # [B, T, D]
    pos = b.constant("encoder_positions", _sinusoids(cfg.max_source_positions, cfg.d_model))
    # The positions sliced to the frame count (Shape -> Gather -> Slice).
    t_len = b.op("Gather", [b.op("Shape", [x]), b.constant(None, np.int32(1))])
    t_vec = b.op("Reshape", [t_len, b.constant(None, np.int32([1]))])
    x = x + b.op("Slice", [pos, b.constant(None, np.int32([0])), t_vec,
                           b.constant(None, np.int32([0]))])
    for i in range(cfg.encoder_layers):
        p = f"model.encoder.layers.{i}"
        h = L.ln(x, f"{p}.self_attn_layer_norm")
        q = L.heads_of(L.linear(h, f"{p}.self_attn.q_proj"))
        k = L.heads_of(L.linear(h, f"{p}.self_attn.k_proj", bias=False))
        v = L.heads_of(L.linear(h, f"{p}.self_attn.v_proj"))
        a = b.op("Attention", [q, k, v], {})
        x = x + L.linear(L.merge(a), f"{p}.self_attn.out_proj")
        fc = b.op("Gelu", [L.linear(L.ln(x, f"{p}.final_layer_norm"), f"{p}.fc1")])
        x = x + L.linear(fc, f"{p}.fc2")
    b.output(L.ln(x, "model.encoder.layer_norm", output_names=["encoder_hidden_states"]))
    return b.finish()


def build_cross_kv(cfg: WhisperConfig, w: Dict[str, np.ndarray]) -> Graph:
    """encoder_hidden_states -> cross K/V per decoder layer (computed once)."""
    b = GraphBuilder()
    L = _Layers(b, cfg, w)
    enc = b.input("encoder_hidden_states", DataType.Float, ("batch", "frames", cfg.d_model))
    outs = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}.encoder_attn"
        k = L.linear(enc, f"{p}.k_proj", bias=False)
        v = L.linear(enc, f"{p}.v_proj")
        outs.append(L.heads_of(k, output_names=[f"cross.{i}.key"]))
        outs.append(L.heads_of(v, output_names=[f"cross.{i}.value"]))
    b.output(*outs)
    return b.finish()


def build_decoder(cfg: WhisperConfig, w: Dict[str, np.ndarray]) -> Graph:
    b = GraphBuilder()
    L = _Layers(b, cfg, w)
    H, D = cfg.heads, cfg.head_dim
    ids = b.input("input_ids", DataType.Int32, ("batch", "seq"))
    attn_mask = b.input("attention_mask", DataType.Int32, ("batch", "total_seq"))
    pos = b.input("position_ids", DataType.Int32, ("batch", "seq"))

    x = b.op("Gather", [L.c("model.decoder.embed_tokens.weight"), ids])
    x = x + b.op("Gather", [L.c("model.decoder.embed_positions.weight"), pos])

    mask_f = b.op("Cast", [attn_mask], {"to": DataType.Float})
    one = b.constant(None, np.float32(1.0))
    neg = b.constant(None, np.float32(-1e30))
    add_mask = b.op("Mul", [b.op("Sub", [one, mask_f]), neg])
    add_mask = b.op("Unsqueeze", [add_mask, b.constant(None, np.int32([1, 2]))])

    presents = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        past_k, past_v = (b.input(f"past_key_values.{i}.decoder.{kv}", DataType.Float,
                                  ("batch", H, "past", D)) for kv in ("key", "value"))
        cross_k, cross_v = (b.input(f"cross.{i}.{kv}", DataType.Float,
                                    ("batch", H, "frames", D)) for kv in ("key", "value"))
        h = L.ln(x, f"{p}.self_attn_layer_norm")
        q = L.heads_of(L.linear(h, f"{p}.self_attn.q_proj"))
        k = L.heads_of(L.linear(h, f"{p}.self_attn.k_proj", bias=False))
        v = L.heads_of(L.linear(h, f"{p}.self_attn.v_proj"))
        a, pk, pv = b.op(
            "Attention", [q, k, v, add_mask, past_k, past_v], {"is_causal": 1}, n_outputs=3,
            output_names=[f"self_attn_{i}", f"present.{i}.decoder.key",
                          f"present.{i}.decoder.value"],
        )
        presents.extend([pk, pv])
        x = x + L.linear(L.merge(a), f"{p}.self_attn.out_proj")
        # Cross attention over the frozen encoder K/V (no mask, not causal).
        q2 = L.heads_of(L.linear(L.ln(x, f"{p}.encoder_attn_layer_norm"),
                                 f"{p}.encoder_attn.q_proj"))
        a2 = b.op("Attention", [q2, cross_k, cross_v], {})
        x = x + L.linear(L.merge(a2), f"{p}.encoder_attn.out_proj")
        fc = b.op("Gelu", [L.linear(L.ln(x, f"{p}.final_layer_norm"), f"{p}.fc1")])
        x = x + L.linear(fc, f"{p}.fc2")

    x = L.ln(x, "model.decoder.layer_norm")
    lm = b.constant(
        "proj_out.weight_t",
        np.ascontiguousarray(w["model.decoder.embed_tokens.weight"].T, np.float32),
    )
    b.output(b.op("MatMul", [x, lm], output_names=["logits"]), *presents)
    return b.finish()


def weights_from_torch(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


class WhisperModel:
    """Encoder, cross K/V and decoder ``Model``s on one device (the card
    unless ``device`` says otherwise), Generator-ready."""

    def __init__(self, cfg: WhisperConfig, weights: Dict[str, np.ndarray],
                 options: Optional[ModelOptions] = None, device=None):
        options = options or ModelOptions()
        self.cfg = cfg
        self.encoder = Model(build_encoder(cfg, weights), options, device=device)
        self.cross_kv = Model(build_cross_kv(cfg, weights), options, device=device)
        self.decoder = Model(build_decoder(cfg, weights), options, device=device)
        self.device = self.decoder.device

    def encode(self, mel):
        """mel [B, n_mels, frames] -> (the decoder's per-step constant
        inputs: ``cross.N.{key,value}`` on the model's device, the encoder
        states)."""
        enc = self.encoder.run({"mel": mel})[0]
        kv = self.cross_kv.run({"encoder_hidden_states": enc})
        names = [f"cross.{i}.{k}" for i in range(self.cfg.decoder_layers)
                 for k in ("key", "value")]
        return dict(zip(names, kv)), enc

    def generator(self, mel, prompt_ids, config=None):
        from ..generate import Generator, GeneratorConfig

        cross, _ = self.encode(mel)
        config = config or GeneratorConfig(bucket_size=32,
                                           max_seq_len=self.cfg.max_target_positions)
        config.constant_inputs = {**config.constant_inputs, **cross}
        return Generator(self.decoder, prompt_ids, config)
