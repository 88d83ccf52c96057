"""Autoregressive Generator (the port of ``rten_tpu/generate/generator.py``;
rten rten-generate/src/generator.rs:398).

Drives any causal-LM graph that follows the Optimum KV-cache naming
conventions (``past_key_values.N.key`` -> ``present.N.key``, discovered by
pattern as in rten generator.rs:267-322). The shape policy is the JAX
package's, so both packages feed the model the same tensors:

* prompts are LEFT-padded to a bucket multiple (the padding masked out, so
  the cache stays right-aligned and contiguous);
* the past KV fed to a decode step is padded to the next capacity bucket,
  and the new token's row is appended to the cache afterwards.

The caches stay on the model's device as torch tensors; the padding and the
append are ``torch.nn.functional.pad`` and ``torch.cat`` there. Per step
the host sees only the [B, V] logits row, for filtering and sampling.

Merged encoder-decoder exports (cross-attention ``encoder`` caches, a
``use_cache_branch`` input) raise ``NotImplementedError``: they need ONNX
loading with ``If`` subgraphs (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..serialize import read_safetensors, write_safetensors
from .filter import LogitsFilter
from .metrics import Metrics
from .sampler import ArgMaxSampler, Sampler

# (pattern, present-name template, is_encoder) triples; rten
# generator.rs:267-322 KVCachePair table.
_KV_PATTERNS = [
    (
        re.compile(r"^past_key_values\.(\d+)\.(decoder|encoder)\.(key|value)$"),
        lambda m: f"present.{m.group(1)}.{m.group(2)}.{m.group(3)}",
        lambda m: m.group(2) == "encoder",
    ),
    (
        re.compile(r"^past_key_values\.(\d+)\.(key|value)$"),
        lambda m: f"present.{m.group(1)}.{m.group(2)}",
        lambda m: False,
    ),
    (
        re.compile(r"^past_(\d+)_(key|value)$"),
        lambda m: f"present_{m.group(1)}_{m.group(2)}",
        lambda m: False,
    ),
]


class GeneratorError(Exception):
    pass


@dataclasses.dataclass
class GeneratorConfig:
    """rten GeneratorConfig + ModelInputsConfig analog
    (rten-generate/src/generator.rs:219-265)."""

    max_seq_len: int = 1024
    bucket_size: int = 128
    sampler: Sampler = dataclasses.field(default_factory=ArgMaxSampler)
    logits_filters: List[LogitsFilter] = dataclasses.field(default_factory=list)
    eos_ids: Optional[Sequence[int]] = None
    # Input/output names (overridable like rten ModelInputsConfig).
    input_ids_name: str = "input_ids"
    attention_mask_name: str = "attention_mask"
    position_ids_name: str = "position_ids"
    logits_name: str = "logits"
    cache_position_name: str = "cache_position"
    use_cache_flag_name: str = "use_cache_branch"
    # Extra constant inputs fed every step.
    constant_inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x else m


class KvEntry:
    def __init__(self, input_name: str, output_name: str, shape):
        self.input_name = input_name
        self.output_name = output_name
        self.shape = shape  # declared (may contain symbolic dims)


class Generator:
    """Iterator over generated token ids (batch-aware: yields [B] arrays,
    or python ints when B == 1)."""

    def __init__(self, model, prompt_ids, config: Optional[GeneratorConfig] = None):
        self.model = model
        self.config = config or GeneratorConfig()
        self.metrics = Metrics()

        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        self.batch = prompt.shape[0]

        self._discover_io()
        self._cache: List[torch.Tensor] = []  # on the model's device, [B, H, t, D]
        self._cache_len = 0
        self._mask: Optional[np.ndarray] = None  # host [B, t] int32
        self._generated: List[np.ndarray] = []
        self._finished = np.zeros(self.batch, bool)
        self._pending_logits: Optional[np.ndarray] = None

        self.metrics.start_step()
        self._prefill(prompt)
        self.metrics.end_prefill(int(prompt.shape[1]))

    # -- model IO discovery --------------------------------------------------

    def _discover_io(self):
        g = self.model.graph
        self.kv: List[KvEntry] = []
        self.input_names = set(self.model.input_names())
        out_names = set(self.model.output_names())
        for nid in g.input_ids:
            name = g.node_name(nid)
            for pat, present, is_encoder in _KV_PATTERNS:
                m = pat.match(name)
                if m:
                    if is_encoder(m):
                        raise NotImplementedError(
                            f"cross-attention cache {name} (merged encoder-decoder "
                            f"exports): ROADMAP.md queue 1 item 12"
                        )
                    out_name = present(m)
                    if out_name not in out_names:
                        raise GeneratorError(
                            f"KV input {name} has no matching output {out_name}"
                        )
                    self.kv.append(KvEntry(name, out_name, getattr(g.nodes[nid], "shape", None)))
                    break
        if self.config.use_cache_flag_name in self.input_names:
            raise NotImplementedError(
                f"'{self.config.use_cache_flag_name}' input (merged Optimum decoders "
                f"with If subgraphs): ROADMAP.md queue 1 item 12"
            )
        if self.config.input_ids_name not in self.input_names:
            raise GeneratorError(
                f"model has no '{self.config.input_ids_name}' input; "
                f"inputs: {sorted(self.input_names)}"
            )
        self.has_mask = self.config.attention_mask_name in self.input_names
        self.has_positions = self.config.position_ids_name in self.input_names
        self.has_cache_position = self.config.cache_position_name in self.input_names
        if not self.has_mask and self.config.bucket_size != 1:
            # Without an attention_mask input bucket padding cannot be
            # masked out of the cache: exact shapes, as the reference runs.
            self.config = dataclasses.replace(self.config, bucket_size=1)
        if self.config.logits_name in out_names:
            self.logits_name = self.config.logits_name
        else:
            non_present = [
                n for n in self.model.output_names()
                if not any(n == e.output_name for e in self.kv)
            ]
            if not non_present:
                raise GeneratorError("model has no logits output")
            self.logits_name = non_present[0]

    def _kv_dims(self, entry: KvEntry) -> Tuple[int, int]:
        shape = entry.shape
        if shape is None or len(shape) != 4:
            raise GeneratorError(
                f"KV input {entry.input_name} needs a declared [B,H,S,D] shape"
            )
        H, D = shape[1], shape[3]
        if not isinstance(H, int) or not isinstance(D, int):
            raise GeneratorError(
                f"KV input {entry.input_name}: head/dim sizes must be concrete "
                f"(got {shape})"
            )
        return H, D

    # -- steps ---------------------------------------------------------------

    def _run(self, input_ids, mask, positions, past: List[torch.Tensor]):
        feed: Dict[str, Any] = {self.config.input_ids_name: input_ids}
        if self.has_mask:
            feed[self.config.attention_mask_name] = mask
        if self.has_positions:
            feed[self.config.position_ids_name] = positions
        if self.has_cache_position:
            # 1-D absolute positions of the current tokens
            # (rten generator.rs varying_inputs for cache_position).
            feed[self.config.cache_position_name] = np.asarray(
                positions, np.int32
            ).reshape(-1)[-input_ids.shape[1]:]
        for e, p in zip(self.kv, past):
            feed[e.input_name] = p
        feed.update(self.config.constant_inputs)
        want = [self.logits_name] + [e.output_name for e in self.kv]
        outs = self.model.run(feed, want)
        return outs[0], outs[1:]

    def _logits_row(self, logits) -> np.ndarray:
        return logits[:, -1].to(torch.float32).cpu().numpy()

    def _prefill(self, prompt: np.ndarray):
        B, T = prompt.shape
        cap = _round_up(T, self.config.bucket_size)
        pad = cap - T
        ids = np.pad(prompt, ((0, 0), (pad, 0)))  # left pad
        mask = np.pad(np.ones((B, T), np.int32), ((0, 0), (pad, 0)))
        positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
        past = []
        for e in self.kv:
            H, D = self._kv_dims(e)
            past.append(torch.zeros((B, H, 0, D), dtype=torch.float32, device=self.model.device))
        logits, presents = self._run(ids, mask, positions, past)
        self._cache = list(presents)
        self._cache_len = cap
        self._mask = mask
        self._pending_logits = self._logits_row(logits)

    def _sample(self) -> np.ndarray:
        logits = self._pending_logits
        prev = (
            np.stack(self._generated, 1) if self._generated else np.zeros((self.batch, 0))
        )
        for f in self.config.logits_filters:
            logits = f.apply(logits, prev)
        tokens = self.config.sampler.sample(logits)
        return tokens.astype(np.int32)

    def _decode_step(self, tokens: np.ndarray):
        B = self.batch
        t = self._cache_len
        cap = _round_up(t + 1, self.config.bucket_size) - 1
        if t + 1 > self.config.max_seq_len:
            raise GeneratorError(f"exceeded max_seq_len={self.config.max_seq_len}")
        kv_pad = cap - t
        past = [F.pad(c, (0, 0, 0, kv_pad)) for c in self._cache] if kv_pad else self._cache
        mask = np.pad(self._mask, ((0, 0), (0, kv_pad)))
        mask = np.concatenate([mask, np.ones((B, 1), np.int32)], 1)
        positions = self._mask.sum(axis=1, dtype=np.int32)[:, None]
        logits, presents = self._run(tokens[:, None], mask, positions, past)
        # The new token's KV sits at index cap of each present; keep the
        # cache contiguous at logical length t + 1.
        self._cache = [torch.cat([c, p[:, :, cap:cap + 1]], dim=2)
                       for c, p in zip(self._cache, presents)]
        self._cache_len = t + 1
        self._mask = np.concatenate([self._mask, np.ones((B, 1), np.int32)], 1)
        self._pending_logits = self._logits_row(logits)

    # -- iterator ------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished.all():
            raise StopIteration
        self.metrics.start_step()
        tokens = self._sample()
        eos = self.config.eos_ids
        if eos is not None:
            self._finished |= np.isin(tokens, np.asarray(list(eos)))
        self._generated.append(tokens)
        if not self._finished.all():
            self._decode_step(tokens)
        self.metrics.end_step()
        return int(tokens[0]) if self.batch == 1 else tokens

    # -- session checkpoint --------------------------------------------------

    def save_session(self, path) -> None:
        """Write the generation state (KV cache + bookkeeping) to a
        safetensors file, so a conversation resumes without a new
        prefill."""
        tensors = {f"cache.{i}": c.cpu().numpy() for i, c in enumerate(self._cache)}
        tensors["mask"] = self._mask
        tensors["generated"] = (
            np.stack(self._generated, 1)
            if self._generated
            else np.zeros((self.batch, 0), np.int32)
        )
        tensors["pending_logits"] = self._pending_logits
        tensors["finished"] = self._finished
        write_safetensors(path, tensors, metadata={"cache_len": str(self._cache_len)})

    def restore_session(self, path) -> None:
        data = read_safetensors(path)
        self._cache = [torch.from_numpy(np.array(data[f"cache.{i}"])).to(self.model.device)
                       for i in range(len(self.kv))]
        self._cache_len = self._cache[0].shape[2] if self.kv else 0
        self._mask = np.array(data["mask"])
        gen = np.array(data["generated"])
        self._generated = [gen[:, i] for i in range(gen.shape[1])]
        self._pending_logits = np.array(data["pending_logits"])
        self._finished = np.array(data["finished"])

    # -- conveniences --------------------------------------------------------

    def generate(self, max_tokens: int) -> np.ndarray:
        """Collect up to max_tokens; returns [B, n] token ids."""
        out = []
        for i, tok in enumerate(self):
            out.append(np.atleast_1d(tok))
            if i + 1 >= max_tokens:
                break
        return np.stack(out, axis=1) if out else np.zeros((self.batch, 0), np.int32)
