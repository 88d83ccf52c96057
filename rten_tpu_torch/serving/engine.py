"""Continuous-batching engine (the port of ``rten_tpu/serving/engine.py``).

* KV caches: preallocated slot-major device tensors per layer, discovered
  from the graph's ``past_key_values.*`` inputs. The model writes new rows
  at each slot's offset in place (the executor's ``donate``), so there is no
  per-token reallocation.
* Paged KV (graphs with a ``block_table`` input): the caches are block
  pools shared by all slots, allocated at their declared shape. The engine
  owns a free list of blocks (block 0 is reserved as the garbage sink) and
  a block table [slots, max_blocks]; an admission reserves each request's
  whole budget of blocks up front, FIFO (a request the pool cannot hold yet
  waits at the head of the queue, and everything behind it with it), and a
  finished, cancelled or timed-out request returns its blocks. The table
  lives on the device and is pushed only when it changed.
* Admission: every queued request that fits a free slot is prefilled in ONE
  forward over all slot rows at a bucketed prompt length. Rows that are not
  admitted carry zero prompts at ``past_lens = 0``; the forward writes into
  fresh zero caches and only admitted rows are copied into the live ones.
  Paged pools are fed live instead, with a table whose rows for slots not
  being admitted point at block 0. The per-tensor activation scale of
  DynamicQuantizeLinear sees every row, so the rows fed are exactly the JAX
  engine's. Graphs without ``last_pos`` (``gather_last=False``) run the
  lm_head over the whole bucket; the admission reads each slot's row at its
  prompt's last index.
* Chunked prefill (``chunked_prefill``): prompts run in ``prefill_bucket``
  chunks at per-slot offsets, every chunk one forward over all slot rows.
  The JAX engine forwards the live caches and keeps the admitted rows with
  ``where``; here a forward writes its caches in place, so each chunk runs
  over copies of the live caches and only the admitted slots' rows are
  copied back (the slots that are decoding keep theirs).
* Shared prefix (``set_shared_prefix``): the prefix is prefilled once.
  Slot-major caches keep its rows apart and stamp them into each
  admission's fresh caches along the cache-position axis; the suffix then
  runs at ``past_lens = P``. Paged pools hold the prefix's full blocks once,
  shared read-only through every table row; the partial boundary block is
  a template copied into each admitted slot's first own block.
* Decode: ``steps_per_dispatch`` steps per dispatch, a plain Python loop
  that keeps tokens and lengths on the device (every slot, live or idle,
  advances its length and writes its KV row, as in the JAX scan) and copies
  the [slots, k] tokens to the host once per dispatch, into pinned memory
  without blocking: only the drain waits for the card. Tokens and lengths
  chain on the device across dispatches until the next admission.
  ``dispatches_per_drain`` issues up to that many dispatches before reading
  any (tokens past a request's end are discarded); ``pipeline_dispatch``
  issues the next dispatch before reading the last (host bookkeeping lags
  one dispatch, hence a KV margin of 2k).
* Sampling: greedy on the device (the graph's ``next_token``, argmax
  kernel), on the host from fetched logits (``sampler``, or
  ``greedy_on_device=False``; one step per dispatch), or on the device
  (``device_sampler``: temperature / top-k / top-p and a Gumbel-max draw
  from an engine-owned ``torch.Generator`` inside the k-step loop). The
  admissions of a device-sampled engine draw on the host from a numpy
  generator seeded like it (``DeviceSampler.sample_host``).
* Multi-LoRA (graphs with ``slot_adapter`` and ``lora.*`` inputs): stacked
  adapters from ``set_lora_adapters``, each slot's adapter id set at its
  admission; both are fed to every forward.
* Deferred KV (graphs with ``recent.*`` inputs, ``deferred_kv=True``): a
  dispatch's k steps keep their new rows in per-layer recent windows
  [slots, H, k, D] (zeroed when the dispatch starts; step t feeds
  ``step_t = t``) and leave the big caches as they are; the dispatch then
  commits every slot's window rows, live or idle, into the big caches at
  the slot's length at the dispatch's start (int4 caches packed with
  ``pack_int4``, int8 quantized per row, f32/bf16 cast), each write clamped
  to ``[0, cap - k]``. A single step commits its one row at once;
  admissions feed one-row dummy windows (the prefill writes the caches).
* Recovery: ``restart()`` re-queues every running request with its tokens
  cleared and zeroes all device state; ``fail_inflight(error)`` fails every
  running and queued request instead. Both reseed the samplers and write a
  paged prefix into the pool again.
"""

from __future__ import annotations

import dataclasses
import itertools
import statistics
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..generate.sampler import ArgMaxSampler, DeviceSampler, Sampler
from ..kernels.flash_attention import pack_int4, quantize_rows
from ..ops.attention import slot_kv_update


class QueueFull(Exception):
    """Backpressure: the admission queue is at max_queue capacity."""


@dataclasses.dataclass(eq=False)  # identity semantics: queue membership &
class Request:                    # cancellation must not match look-alikes
    prompt: List[int]
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    request_id: int = 0
    timeout_s: Optional[float] = None
    adapter_id: int = 0
    # Filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    timed_out: bool = False
    error: Optional[str] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class ContinuousBatchingEngine:
    # Class-level fallbacks for submit()'s validation state (the JAX
    # engine's), so partly constructed engines and subclasses stay safe.
    prefix_tokens: Optional[List[int]] = None
    prefix_len = 0
    _adapter_nid = None
    lora_input_ids: Dict[str, int] = {}
    paged = False
    _prefix_shared: tuple = ()          # full prefix blocks, shared read-only
    _prefix_tmpl: Optional[int] = None  # partial boundary template block
    _prefix_nblocks = 0

    def __init__(
        self,
        model,
        *,
        n_layer: int,
        n_head: int,
        head_dim: int,
        slots: int = 4,
        capacity: int = 512,
        prefill_bucket: int = 64,
        sampler: Optional[Sampler] = None,
        device_sampler: Optional[DeviceSampler] = None,
        greedy_on_device: bool = False,
        steps_per_dispatch: int = 1,
        dispatches_per_drain: int = 1,
        pipeline_dispatch: bool = False,
        chunked_prefill: bool = False,
        max_queue: Optional[int] = None,
        params: Optional[Dict[int, torch.Tensor]] = None,
    ):
        """``params``: weights of the rank's graph from
        ``parallel.shard_constants`` / ``shard_constants_by_plan``, making
        the engine tensor-parallel: it runs the rank's model they carry
        (``params.model``: local head counts, sliced weights, collectives)
        in place of ``model``, its caches allocated at the local head count
        from that graph's declared shapes, and feeds them to every forward.
        Every rank runs the same engine calls; the greedy token (a
        ``ShardedArgMax``) and the device sampler's draw (from the gathered
        logits, the same generator state on every rank) are the same on
        every rank. ``n_head`` stays the global count."""
        model = getattr(params, "model", None) or model
        self.model = model
        self.executor = model.executor
        self.device = model.device
        self.g = model.graph
        self.slots = slots
        self.capacity = capacity
        self.prefill_bucket = prefill_bucket
        self.sampler = sampler or ArgMaxSampler()
        self.device_sampler = device_sampler

        # Paged KV: block pools plus a per-slot block_table input.
        self._bt_nid = self.g.find_node("block_table")
        self.paged = self._bt_nid is not None
        if self.paged and chunked_prefill:
            raise ValueError("chunked_prefill is not supported on paged-KV graphs")

        # Cache buffers from graph IO: every past_key_values.* input, with
        # its declared trailing shape (slot-major caches) or whole shape
        # (paged pools) and dtype.
        self.cache_names = []
        self._cache_alloc = []  # (full allocation shape, torch dtype)
        for nid in self.g.input_ids:
            name = self.g.node_name(nid)
            if not name.startswith("past_key_values."):
                continue
            node = self.g.nodes[nid]
            dims = tuple(node.shape) if node.shape else None
            if not self.paged and dims is not None:
                dims = dims[1:]
            if dims is None or any(not isinstance(d, int) for d in dims):
                raise ValueError(
                    f"cache input {name} needs a concrete "
                    f"{'shape' if self.paged else 'trailing shape'}, got {node.shape}"
                )
            shape = dims if self.paged else (slots,) + dims
            self.cache_names.append(name)
            self._cache_alloc.append((shape, node.dtype.torch_dtype))
        self.present_names = [
            "present." + n[len("past_key_values."):] for n in self.cache_names
        ]
        self.cache_ids = [self.g.find_node(n) for n in self.cache_names]
        self.in_ids = {
            n: self.g.find_node(n)
            for n in ("input_ids", "past_lens", "position_ids")
        }
        # gather_last graphs take per-slot prompt-final indices and emit one
        # logits row per slot; decode steps feed zeros.
        self.last_pos_id = self.g.find_node("last_pos")
        # Greedy on the device: fetch next_token instead of the logits.
        self.greedy_on_device = (
            greedy_on_device and self.g.find_node("next_token") is not None
            and sampler is None and device_sampler is None
        )
        tok_out = "next_token" if self.greedy_on_device else "logits"
        self.out_ids = [self.g.find_node(tok_out)] + [
            self.g.find_node(n) for n in self.present_names
        ]

        # Deferred-KV graphs: per-layer recent.{i}.key/value windows and a
        # step_t input; each window commits into its cache (and scales).
        self.recent_names = [self.g.node_name(n) for n in self.g.input_ids
                             if self.g.node_name(n).startswith("recent.")]
        self.deferred_kv = bool(self.recent_names)
        if self.deferred_kv and prefill_bucket < 2:
            # The deferred attention ops tell prefill from decode by S > 1:
            # a 1-token prefill would run as a decode step and route the
            # prompt's KV into windows the prefill discards.
            raise ValueError(
                "deferred-KV graphs need prefill_bucket >= 2 (a 1-token "
                "prefill is indistinguishable from a decode step)"
            )
        self.recent_ids = [self.g.find_node(n) for n in self.recent_names]
        self.step_t_id = self.g.find_node("step_t") if self.deferred_kv else None
        self._recent_alloc = []  # (heads, head_dim, torch dtype) per window
        self._commit_plan = []   # (recent index, cache index, scale index or None)
        for ri, name in enumerate(self.recent_names):
            node = self.g.nodes[self.recent_ids[ri]]
            self._recent_alloc.append((node.shape[1], node.shape[3], node.dtype.torch_dtype))
            base = "past_key_values." + name[len("recent."):]
            scale = base + "_scale"
            self._commit_plan.append((
                ri, self.cache_names.index(base),
                self.cache_names.index(scale) if scale in self.cache_names else None,
            ))
        # The windows of the current forward, and every set allocated so far
        # by row count (one row for admissions and single steps, k rows for
        # dispatches).
        self._recents: List[torch.Tensor] = []
        self._recent_sets: Dict[int, List[torch.Tensor]] = {}
        # Inputs the model may write in place: the caches and the windows.
        self._donate = self.cache_ids + self.recent_ids

        # Extra inputs fed to every forward ({node id: device tensor}): the
        # per-slot adapter ids and the stacked adapters of a LoRA graph.
        self.params: Dict[int, torch.Tensor] = dict(params or {})
        self._adapter_nid = self.g.find_node("slot_adapter")
        self.lora_input_ids = {
            self.g.node_name(n): n for n in self.g.input_ids
            if self.g.node_name(n).startswith("lora.")
        }
        self.slot_adapter = np.zeros(slots, np.int32)
        if self._adapter_nid is not None:
            self.params[self._adapter_nid] = self._to_device(self.slot_adapter)

        if self.paged:
            # max_blocks comes from the table's declared width; the logical
            # per-slot capacity max_blocks * block_size must be ``capacity``.
            self.max_blocks = int(self.g.nodes[self._bt_nid].shape[1])
            shape0 = self._cache_alloc[0][0]
            self.n_blocks = int(shape0[0])
            # Head-major pools are [NB, H, BS, D], cat pools [NB, BS, H*D].
            self.block_size = int(shape0[1] if len(shape0) == 3 else shape0[2])
            if capacity != self.max_blocks * self.block_size:
                raise ValueError(
                    f"capacity {capacity} != block_table width "
                    f"{self.max_blocks} * block_size {self.block_size}"
                )
            self._free_blocks = list(range(self.n_blocks - 1, 0, -1))
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
            self.block_table = np.zeros((slots, self.max_blocks), np.int32)
            self._bt_dev: Optional[torch.Tensor] = None  # None: push at next use

        self.caches = self._zero_caches()
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_len = np.zeros(slots, np.int32)
        self.slot_last_tok = np.zeros(slots, np.int32)
        self.queue: deque = deque()
        self.max_queue = max_queue
        self._req_counter = itertools.count()
        self._last_step_s: Optional[float] = None
        # Completed requests awaiting collection (run() returns them;
        # long-running callers drain_finished()). stats() reads the bounded
        # windows, so draining loses no observability.
        self.finished: List[Request] = []
        self.finished_count = 0
        self._ttft_window: deque = deque(maxlen=2048)
        self._latency_window: deque = deque(maxlen=2048)
        self.steps = 0
        self.decode_tokens = 0

        # Shared prefix: its tokens, and (slot-major caches) its rows per
        # cache [1, ..., P, ...].
        self.prefix_tokens = None
        self.prefix_len = 0
        self._prefix_rows: Optional[List[torch.Tensor]] = None
        self.chunked_prefill = chunked_prefill

        # Fused multi-step decode only where the token is picked on the
        # device (greedy or sampled); host sampling reads every step.
        self.steps_per_dispatch = max(1, int(
            steps_per_dispatch
            if (self.greedy_on_device or self.device_sampler is not None) else 1))
        self.dispatches_per_drain = max(1, dispatches_per_drain)
        self.pipeline_dispatch = pipeline_dispatch and self.steps_per_dispatch > 1
        self._seed_samplers()
        # The dispatch issued but not yet read: ((host tokens, event),
        # active slots, k).
        self._inflight = None
        # Device-chained (tokens, lens) of the last dispatch; None when the
        # host bookkeeping is authoritative (after an admission).
        self._dev_state = None

    # -- device helpers ---------------------------------------------------

    def _seed_samplers(self):
        """The device sampler's generator on the engine's device and its
        numpy mirror for admissions, both from the sampler's seed."""
        ds = self.device_sampler
        self._dev_gen = ds.init_generator(self.device) if ds is not None else None
        self._host_rng = np.random.default_rng(ds.seed) if ds is not None else None

    def _zero_caches(self) -> List[torch.Tensor]:
        return [torch.zeros(shape, dtype=dtype, device=self.device)
                for shape, dtype in self._cache_alloc]

    def _forward(self, caches, ids, lens, pos, last_pos=None, table=None, step=None,
                 presents_only=False):
        """One model run over all slot rows; the caches (and a deferred
        graph's windows) are updated in place. Inputs are device tensors or
        numpy arrays. Paged graphs read the block table ``table`` (the
        engine's own by default); deferred graphs the windows
        ``self._recents`` at ``step`` ([1] int32 on the device).
        Returns (next_token or logits, presents); ``presents_only`` skips
        the lm_head (the first is then None)."""
        feed = {
            self.in_ids["input_ids"]: ids,
            self.in_ids["past_lens"]: lens,
            self.in_ids["position_ids"]: pos,
        }
        if self.last_pos_id is not None:
            feed[self.last_pos_id] = (np.zeros(self.slots, np.int32) if last_pos is None
                                      else last_pos)
        if self.paged:
            feed[self._bt_nid] = self._bt_sync() if table is None else table
        if self.deferred_kv:
            feed[self.step_t_id] = step
            feed.update(zip(self.recent_ids, self._recents))
        feed.update(self.params)
        feed.update(zip(self.cache_ids, caches))
        out_ids = self.out_ids[1:] if presents_only else self.out_ids
        outs = self.executor.run(feed, out_ids, donate=self._donate)
        if presents_only:
            return None, list(outs)
        return outs[0], list(outs[1:])

    def _zero_recents(self, rows: int) -> torch.Tensor:
        """Zeroed windows of ``rows`` rows for every layer, allocated once
        per row count; returns step 0 ([1] int32 on the device)."""
        if rows in self._recent_sets:
            self._recents = self._recent_sets[rows]
            for r in self._recents:
                r.zero_()
        else:
            self._recents = self._recent_sets[rows] = [
                torch.zeros((self.slots, h, rows, d), dtype=dt, device=self.device)
                for h, d, dt in self._recent_alloc]
        return torch.zeros(1, dtype=torch.int32, device=self.device)

    def _prefill_step(self):
        """A deferred graph's prefill feeds one-row dummy windows (the
        prefill writes the caches; the windows pass through)."""
        return self._zero_recents(1) if self.deferred_kv else None

    def _commit_recent(self, lens0: torch.Tensor):
        """Write every window's rows into its big cache at each slot's
        length at the dispatch's start, once per dispatch (the JAX engine's
        ``_commit_recent``): int4 caches packed, int8 caches quantized per
        row (absmax / 127), f32/bf16 caches cast; each write clamped to
        [0, cap - rows]."""
        for ri, ci, si in self._commit_plan:
            rows = self._recents[ri].to(torch.float32)
            cache = self.caches[ci]
            if si is None:
                slot_kv_update(cache, rows, lens0)
                continue
            q, s = pack_int4(rows) if cache.dtype == torch.uint8 else quantize_rows(rows)
            slot_kv_update(cache, q, lens0)
            slot_kv_update(self.caches[si], s, lens0)

    def _multi_step(self, k: int, toks: torch.Tensor, lens: torch.Tensor):
        """k decode steps chained on the device: [slots] tokens and lengths
        in, tokens [slots, k] out. Every slot advances; each step's token is
        the graph's greedy next_token, or the device sampler's draw from the
        step's logits. A deferred graph's steps write the windows; the
        dispatch commits them."""
        steps = None
        if self.deferred_kv:
            self._zero_recents(k)
            steps = torch.arange(k, dtype=torch.int32, device=self.device)
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        lens0 = lens
        seq = []
        for t in range(k):
            out, self.caches = self._forward(
                self.caches, toks[:, None], lens, lens[:, None], zeros,
                step=None if steps is None else steps[t:t + 1],
            )
            if self.device_sampler is not None:
                toks, self._dev_gen = self.device_sampler.sample(out[:, 0], self._dev_gen)
            else:
                toks = out[:, 0].to(torch.int32)
            lens = lens + 1
            seq.append(toks)
        if self.deferred_kv:
            self._commit_recent(lens0)
        return toks, lens, torch.stack(seq, dim=1)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _positions(self, start: int, T: int) -> np.ndarray:
        """position_ids [slots, T]: start, start + 1, ... in every row."""
        return np.tile(start + np.arange(T, dtype=np.int32), (self.slots, 1))

    def _fetch_async(self, t: torch.Tensor):
        """Start copying ``t`` to the host without blocking: a pinned
        buffer and the event that marks the copy done (CPU tensors are
        already there)."""
        if t.device.type != "cuda":
            return t, None
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return buf, event

    def _copy_rows(self, fresh, slots):
        """Copy the rows of ``slots`` from ``fresh`` into the live caches."""
        rows = self._to_device(np.asarray(slots, np.int64))
        for c, p in zip(self.caches, fresh):
            c.index_copy_(0, rows, p.index_select(0, rows))

    def _select(self, out: torch.Tensor, last_idx: np.ndarray) -> np.ndarray:
        """Each slot's prompt-final token or logits row on the host: the
        gathered row, or (full-bucket graphs) the row at ``last_idx``."""
        if self.last_pos_id is not None:
            sel = out[:, 0]
        else:
            sel = out[torch.arange(self.slots, device=out.device),
                      self._to_device(last_idx.astype(np.int64))]
        return sel.cpu().numpy()

    # -- paged-KV block allocator --------------------------------------------

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request must own to cover every position it can write:
        prefill rows 0..P-1, decode rows up to P+max_new-2, plus the fused
        dispatch's overrun (tokens past eos or the budget still write KV;
        bounded by k per drain group, 2k when pipelining). With a shared
        prefix, its full blocks are shared, not owned (the partial boundary
        block is owned: the slot keeps writing into it)."""
        span = min(prompt_len + max_new + 2 * max(self.steps_per_dispatch, 1),
                   self.capacity)
        return -(-span // self.block_size) - len(self._prefix_shared)

    def _reserve_blocks(self, slot: int, n: int) -> bool:
        """Assign n pool blocks to ``slot``; False if the pool is short (the
        caller re-queues the request). The slot's table row is [shared
        prefix blocks..., own blocks...]."""
        if len(self._free_blocks) < n:
            return False
        blocks = [self._free_blocks.pop() for _ in range(n)]
        self._slot_blocks[slot] = blocks
        ns = len(self._prefix_shared)
        self.block_table[slot] = 0
        self.block_table[slot, :ns] = self._prefix_shared
        self.block_table[slot, ns:ns + n] = blocks
        self._bt_dev = None
        return True

    def _release_blocks(self, slot: int):
        """Return a finished slot's blocks to the pool and point its table
        row at the garbage sink (block 0) before any block is reused: the
        freed slot keeps writing rows in fused dispatches."""
        if not self.paged or not self._slot_blocks[slot]:
            return
        self._free_blocks.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.block_table[slot] = 0
        self._bt_dev = None

    def _bt_sync(self) -> torch.Tensor:
        """The block table on the device, pushed once per change."""
        if self._bt_dev is None:
            self._bt_dev = self._to_device(self.block_table)
        return self._bt_dev

    # -- pipelined dispatch --------------------------------------------------

    def _issue_multi(self, from_host: bool):
        """Launch one fused k-step dispatch; does not wait for the card."""
        if from_host or self._dev_state is None:
            toks = self._to_device(self.slot_last_tok)
            lens = self._to_device(self.slot_len)
        else:
            toks, lens = self._dev_state
        toks, lens, tok_seq = self._multi_step(self.steps_per_dispatch, toks, lens)
        self._dev_state = (toks, lens)
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        self._inflight = (self._fetch_async(tok_seq), active, self.steps_per_dispatch)

    def _drain_inflight(self):
        """Consume the in-flight dispatch's tokens into host bookkeeping."""
        rec, self._inflight = self._inflight, None
        self._drain_record(rec)

    def _drain_record(self, rec):
        if rec is None:
            return
        (tok_seq, event), active, k = rec
        if event is not None:
            event.synchronize()  # the only wait for the card
        tok_seq = tok_seq.numpy()
        self.steps += k
        for slot in active:
            req = self.slot_req[slot]
            if req is None:
                continue  # finished in an earlier drain; tokens discarded
            toks = tok_seq[slot]
            cut = min(k, req.max_new_tokens - len(req.generated))
            if req.eos_id is not None:
                hits = np.nonzero(toks[:cut] == req.eos_id)[0]
                if hits.size:
                    cut = int(hits[0]) + 1
            accepted = toks[:cut]
            req.generated.extend(int(t) for t in accepted)
            self.slot_len[slot] += cut
            if cut:
                self.slot_last_tok[slot] = int(accepted[-1])
            self.decode_tokens += cut
            if cut:
                self._maybe_finish(slot, int(accepted[-1]))

    # -- public API ----------------------------------------------------------

    def set_lora_adapters(self, by_name: Dict[str, np.ndarray]):
        """Install stacked LoRA adapters ([n_adapters, ...] arrays keyed by
        the graph's lora.* input names), every one of them; submit(
        adapter_id=j) then selects row j of each stack for its request."""
        if not self.lora_input_ids:
            raise ValueError("graph was not built with lora_rank > 0")
        missing = sorted(set(self.lora_input_ids) - set(by_name))
        if missing:
            raise ValueError(f"missing adapter arrays for: {missing}")
        for name, nid in self.lora_input_ids.items():
            arr = np.asarray(by_name[name], np.float32)
            node = self.g.nodes[nid]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{name}: expected shape {node.shape}, got {arr.shape}")
            self.params[nid] = self._to_device(arr)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               adapter_id: int = 0) -> Request:
        # Validate here: a bad request must fail at submit time, not crash
        # the serving loop mid-step (and every co-admitted request with it).
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        if self.prefix_tokens is not None and (
            len(prompt) <= self.prefix_len
            or list(prompt[: self.prefix_len]) != self.prefix_tokens
        ):
            raise ValueError(
                "with a shared prefix set, every prompt must start with it "
                "and extend it by >= 1 token"
            )
        if len(prompt) > self.capacity - max_new_tokens:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds KV capacity {self.capacity}"
            )
        if self.paged:
            need = self._blocks_needed(len(prompt), max_new_tokens)
            have = self.n_blocks - 1 - self._prefix_nblocks
            if need > have:
                # Could never be admitted, even with an empty pool.
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has {have}"
                )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); retry later"
            )
        if adapter_id and self._adapter_nid is None:
            raise ValueError("adapter_id requires a graph built with lora_rank > 0")
        if self.lora_input_ids and not (
            0 <= adapter_id
            < self.g.nodes[next(iter(self.lora_input_ids.values()))].shape[0]
        ):
            # An out-of-range id would gather a NaN adapter on the device.
            raise ValueError(f"adapter_id {adapter_id} out of range")
        req = Request(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            timeout_s=timeout_s,
            adapter_id=adapter_id,
            request_id=next(self._req_counter),
            submitted_at=time.perf_counter(),
        )
        self.queue.append(req)
        return req

    def _host_sample(self, logits: np.ndarray) -> np.ndarray:
        """Sample [B, V] logits on the host: the device sampler's numpy
        mirror when one is set (the engine's generator), else the sampler."""
        if self.device_sampler is not None:
            return self.device_sampler.sample_host(logits, self._host_rng)
        return self.sampler.sample(logits)

    def _finish(self, req: Request):
        self.finished.append(req)
        self.finished_count += 1
        if req.ttft_s is not None:
            self._ttft_window.append(req.ttft_s)
        if req.finished_at is not None:
            self._latency_window.append(req.finished_at - req.submitted_at)

    def cancel(self, req: Request) -> bool:
        """Cancel a queued or running request. Queued requests never run;
        running ones free their slot at the next step."""
        if req.done:
            return False
        req.cancelled = True
        if req in self.queue:
            self.queue.remove(req)
            req.done = True
            req.finished_at = time.perf_counter()
            self._finish(req)
        return True

    def _expire_and_cancel(self):
        """Free slots whose requests were cancelled or exceeded timeout_s."""
        now = time.perf_counter()
        for slot in range(self.slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            expired = (
                req.timeout_s is not None
                and now - req.submitted_at > req.timeout_s
            )
            if req.cancelled or expired:
                req.timed_out = expired and not req.cancelled
                req.done = True
                req.finished_at = now
                self._finish(req)
                self.slot_req[slot] = None
                self.slot_len[slot] = 0
                self._release_blocks(slot)
        for req in list(self.queue):
            if req.timeout_s is not None and now - req.submitted_at > req.timeout_s:
                self.queue.remove(req)
                req.timed_out = True
                req.done = True
                req.finished_at = now
                self._finish(req)

    def health(self) -> Dict:
        """Liveness probe: runs a tiny computation on the device."""
        status = "ok"
        err = None
        try:
            x = torch.zeros((), dtype=torch.int32, device=self.device) + 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if int(x) != 1:
                raise RuntimeError("device returned a wrong value")
        except Exception as e:  # noqa: BLE001 - any device failure
            status = "device_error"
            err = repr(e)
        return {
            "status": status,
            "error": err,
            "active_slots": sum(r is not None for r in self.slot_req),
            "queued": len(self.queue),
            "inflight_dispatch": self._inflight is not None,
            "last_step_s": self._last_step_s,
        }

    def has_work(self) -> bool:
        return (bool(self.queue) or any(r is not None for r in self.slot_req)
                or self._inflight is not None)

    def has_pending_results(self) -> bool:
        return self._inflight is not None

    def stats(self) -> Dict:
        """Aggregate serving metrics (rten Metrics analog, per engine)."""
        ttfts = list(self._ttft_window)
        lat = list(self._latency_window)
        return {
            "finished_requests": self.finished_count,
            "decode_tokens": self.decode_tokens,
            "decode_steps": self.steps,
            "ttft_p50_s": statistics.median(ttfts) if ttfts else None,
            "latency_p50_s": statistics.median(lat) if lat else None,
            "active_slots": sum(r is not None for r in self.slot_req),
            "queued": len(self.queue),
        }

    def run(self) -> List[Request]:
        """Drain the queue; returns finished requests in completion order."""
        while self.has_work():
            self.step()
        return self.finished

    def drain_finished(self) -> List[Request]:
        """Pop and return all completed requests."""
        out, self.finished = self.finished, []
        return out

    def _reset_device_state(self):
        """Drop the in-flight dispatch, reseed the samplers, release every
        slot's blocks and zero the slots' bookkeeping, the caches and the
        deferred windows (tokens and lengths chain from the host again),
        then write a paged prefix into the zeroed pool again."""
        self._inflight = None
        self._dev_state = None
        # Seed determinism holds across a recovery: sampling draws from the
        # seed's stream again.
        self._seed_samplers()
        for slot in range(self.slots):
            self._release_blocks(slot)
        self.slot_len[:] = 0
        self.slot_last_tok[:] = 0
        self.caches = self._zero_caches()
        for windows in self._recent_sets.values():
            for r in windows:
                r.zero_()
        self._recompute_prefix_pool()

    def restart(self) -> List[Request]:
        """Deterministic recovery (the JAX engine's ``restart``): re-queue
        every running request at the head of the queue with its tokens
        cleared, release the blocks and zero the caches and windows. Prefill
        is deterministic, so the re-queued requests regenerate the same
        tokens. Returns the re-queued requests."""
        requeued = []
        for slot in range(self.slots):
            req = self.slot_req[slot]
            if req is not None:
                req.generated.clear()
                req.first_token_at = None
                self.queue.appendleft(req)
                requeued.append(req)
                self.slot_req[slot] = None
        self._reset_device_state()
        return requeued

    def fail_inflight(self, error: str) -> List[Request]:
        """Fail every running and queued request with ``error`` (for a step
        that raised: the in-flight state cannot be trusted, but waiters must
        be released) and reset the device state as ``restart`` does.
        Returns the failed requests."""
        failed = []
        now = time.perf_counter()
        for slot in range(self.slots):
            req = self.slot_req[slot]
            if req is not None:
                failed.append(req)
                self.slot_req[slot] = None
        failed.extend(self.queue)
        self.queue.clear()
        for req in failed:
            req.error = error
            req.done = True
            req.finished_at = now
            self._finish(req)
        self._reset_device_state()
        return failed

    # -- shared prefix --------------------------------------------------------

    def set_shared_prefix(self, tokens: Sequence[int]):
        """Prefill a shared prompt prefix (a system prompt) once and keep
        its KV rows; every later prompt must start with it and extend it by
        at least one token, and only its suffix is prefilled. Needs an idle
        engine; an empty prefix clears it."""
        if self.has_work():
            raise ValueError("set_shared_prefix requires an idle engine")
        tokens = list(tokens)

        def drop_paged_prefix():
            # Return the previous prefix's blocks, only once the new prefix
            # has passed every check (a failed call keeps the old one).
            if not self.paged:
                return
            self._free_blocks.extend(self._prefix_shared)
            if self._prefix_tmpl is not None:
                self._free_blocks.append(self._prefix_tmpl)
            self._prefix_shared, self._prefix_tmpl = [], None
            self._prefix_nblocks = 0
            self._bt_dev = None

        if not tokens:
            drop_paged_prefix()
            self.prefix_tokens, self._prefix_rows, self.prefix_len = None, None, 0
            return
        if len(tokens) >= self.capacity:
            raise ValueError("prefix exceeds KV capacity")
        if self.deferred_kv and len(tokens) < 2:
            # A one-token forward runs as a decode step on deferred graphs
            # (its KV goes to the discarded windows).
            raise ValueError("deferred-KV graphs need a shared prefix of >= 2 tokens")
        if self.lora_input_ids:
            # The prefix rows depend on the adapter, but every slot would
            # get the same rows whatever its adapter_id.
            raise ValueError(
                "shared-prefix caching is not supported on LoRA graphs "
                "(prefix KV is adapter-dependent)"
            )
        P = len(tokens)
        if self.paged:
            nfull, rem = divmod(P, self.block_size)
            need = nfull + (1 if rem else 0)
            # The old prefix's blocks count as available.
            if len(self._free_blocks) + self._prefix_nblocks < need + 1:
                raise ValueError(
                    f"prefix needs {need} KV blocks; pool has only "
                    f"{len(self._free_blocks) + self._prefix_nblocks} "
                    "reclaimable (>= 1 must remain for requests)"
                )
            drop_paged_prefix()
            blocks = [self._free_blocks.pop() for _ in range(need)]
            self._prefix_shared = blocks[:nfull]
            self._prefix_tmpl = blocks[nfull] if rem else None
            self._prefix_nblocks = need
            self._bt_dev = None
            self.prefix_tokens = tokens
            self.prefix_len = P
            self._prefix_rows = None
            self._recompute_prefix_pool()
            return
        ids = np.zeros((self.slots, P), np.int32)
        ids[0] = tokens
        pos = self._positions(0, P)
        _, presents = self._forward(
            self._zero_caches(), ids, np.zeros(self.slots, np.int32), pos,
            np.full(self.slots, P - 1, np.int32), step=self._prefill_step(),
            presents_only=True)
        # Slot 0's first P rows along the cache-position axis (ndim - 2:
        # head-major caches and scales keep it at dim 2, cat caches at 1).
        self._prefix_rows = [
            p[(slice(0, 1),) + (slice(None),) * (p.ndim - 3) + (slice(0, P),)].clone()
            for p in presents
        ]
        self.prefix_tokens = tokens
        self.prefix_len = P

    def _recompute_prefix_pool(self):
        """Write the prefix's KV rows into its reserved blocks: when it is
        set, and again after restart()/fail_inflight() zero the pool (the
        slot-major form keeps its rows apart; a paged prefix lives in the
        pool)."""
        if not (self.paged and self.prefix_tokens):
            return
        tokens = self.prefix_tokens
        P = len(tokens)
        blocks = list(self._prefix_shared)
        if self._prefix_tmpl is not None:
            blocks.append(self._prefix_tmpl)
        table = np.zeros_like(self.block_table)
        table[0, : len(blocks)] = blocks
        ids = np.zeros((self.slots, P), np.int32)
        ids[0] = tokens
        pos = self._positions(0, P)
        _, self.caches = self._forward(
            self.caches, ids, np.zeros(self.slots, np.int32), pos,
            np.full(self.slots, P - 1, np.int32), table=self._to_device(table),
            presents_only=True)

    # -- internals -----------------------------------------------------------

    def _round_up(self, x: int) -> int:
        m = self.prefill_bucket
        return ((x + m - 1) // m) * m if x else m

    def _start(self, admissions, sel):
        """Each admitted request's first token from its slot's prompt-final
        output ``sel[slot]`` (a token, or logits sampled on the host), and
        the slot's state."""
        now = time.perf_counter()
        for slot, req in admissions:
            if self.greedy_on_device:
                tok = int(sel[slot])
            else:
                tok = int(self._host_sample(np.asarray(sel[slot])[None])[0])
            req.first_token_at = now
            req.generated.append(tok)
            self.slot_req[slot] = req
            self.slot_len[slot] = len(req.prompt)
            self.slot_last_tok[slot] = tok
            self._maybe_finish(slot, tok)

    def _admit(self, admissions):
        """Prefill a batch of (slot, request) pairs in ONE forward over all
        slot rows (or in chunks, or after a shared prefix). Slot-major
        caches: the forward writes fresh zero caches and the admitted rows
        are copied into the live ones. Paged pools: each admission first
        reserves its blocks (FIFO: the first request the pool cannot hold
        goes back to the head of the queue with every one behind it), then
        the forward writes the live pools through a table whose other rows
        point at block 0."""
        self._dev_state = None
        if self.paged:
            kept = []
            for idx, (slot, req) in enumerate(admissions):
                if not self._reserve_blocks(
                        slot, self._blocks_needed(len(req.prompt), req.max_new_tokens)):
                    for _, r2 in reversed(admissions[idx:]):
                        self.queue.appendleft(r2)
                    break
                kept.append((slot, req))
            admissions = kept
            if not admissions:
                return
        if self._adapter_nid is not None:
            # Each admitted prompt runs under its own adapter.
            for slot, req in admissions:
                self.slot_adapter[slot] = req.adapter_id
            self.params[self._adapter_nid] = self._to_device(self.slot_adapter)
        if self.prefix_tokens is not None:
            self._admit_with_prefix(admissions)
            return
        if self.chunked_prefill:
            self._admit_chunked(admissions)
            return
        T = self._round_up(max(len(r.prompt) for _, r in admissions))
        ids = np.zeros((self.slots, T), np.int32)
        last_idx = np.zeros(self.slots, np.int32)
        for slot, req in admissions:
            ids[slot, : len(req.prompt)] = req.prompt
            last_idx[slot] = len(req.prompt) - 1
        pos = self._positions(0, T)
        args = (ids, np.zeros(self.slots, np.int32), pos, last_idx)
        if self.paged:
            table = np.zeros_like(self.block_table)
            for slot, _ in admissions:
                table[slot] = self.block_table[slot]
            out, self.caches = self._forward(self.caches, *args, self._to_device(table),
                                             self._prefill_step())
        else:
            out, fresh = self._forward(self._zero_caches(), *args, step=self._prefill_step())
            self._copy_rows(fresh, [s for s, _ in admissions])
        self._start(admissions, self._select(out, last_idx))

    def _admit_with_prefix(self, admissions):
        """Prefill only each prompt's suffix at ``past_lens = P`` after the
        shared prefix: stamped into fresh caches (slot-major), or read from
        the pool through the shared blocks, the boundary block copied into
        each admitted slot's first own block (paged)."""
        P = self.prefix_len
        for _, req in admissions:  # checked at submit; a prefix change since
            if len(req.prompt) <= P or req.prompt[:P] != self.prefix_tokens:
                raise ValueError(
                    "with a shared prefix set, every prompt must extend it "
                    f"by >= 1 token (request {req.request_id})"
                )
        T = self._round_up(max(len(r.prompt) - P for _, r in admissions))
        ids = np.zeros((self.slots, T), np.int32)
        last_idx = np.zeros(self.slots, np.int32)
        for slot, req in admissions:
            suffix = req.prompt[P:]
            ids[slot, : len(suffix)] = suffix
            last_idx[slot] = len(suffix) - 1
        pos = self._positions(P, T)
        args = (ids, np.full(self.slots, P, np.int32), pos, last_idx)
        if self.paged:
            table = np.zeros_like(self.block_table)
            first_own = np.zeros(self.slots, np.int64)  # 0: the garbage sink
            ns = len(self._prefix_shared)
            for slot, _ in admissions:
                table[slot] = self.block_table[slot]
                first_own[slot] = self.block_table[slot, ns]
            if self._prefix_tmpl is not None:
                # The suffix writes on top of the template's rows from
                # offset P % block_size.
                idx = self._to_device(first_own)
                for c in self.caches:
                    c[idx] = c[self._prefix_tmpl].clone()
            out, self.caches = self._forward(self.caches, *args, self._to_device(table))
        else:
            base = self._zero_caches()
            for c, rows in zip(base, self._prefix_rows):
                c[(slice(None),) * (c.ndim - 2) + (slice(0, P),)] = rows
            out, fresh = self._forward(base, *args, step=self._prefill_step())
            self._copy_rows(fresh, [s for s, _ in admissions])
        self._start(admissions, self._select(out, last_idx))

    def _admit_chunked(self, admissions):
        """Prefill in ``prefill_bucket`` chunks at per-slot offsets. Each
        chunk is one forward over copies of the live caches (rows that are
        not admitted run zero ids at ``past_lens = 0``, as in the JAX
        engine, and would overwrite the first rows of a decoding slot); the
        admitted slots' rows are copied back."""
        chunk = self.prefill_bucket
        n_chunks = -(-max(len(r.prompt) for _, r in admissions) // chunk)
        pos0 = np.arange(chunk, dtype=np.int32)[None]
        final_sel = {}
        for c in range(n_chunks):
            ids = np.zeros((self.slots, chunk), np.int32)
            lens = np.zeros(self.slots, np.int32)
            last_idx = np.zeros(self.slots, np.int32)
            rows, finals = [], []
            for slot, req in admissions:
                seg = req.prompt[c * chunk: (c + 1) * chunk]
                if not seg:
                    continue
                ids[slot, : len(seg)] = seg
                lens[slot] = c * chunk
                rows.append(slot)
                if (c + 1) * chunk >= len(req.prompt):
                    last_idx[slot] = len(seg) - 1
                    finals.append(slot)
            out, fresh = self._forward(
                [t.clone() for t in self.caches], ids, lens, lens[:, None] + pos0,
                last_idx, step=self._prefill_step())
            self._copy_rows(fresh, rows)
            if finals:
                sel = self._select(out, last_idx)
                for slot in finals:
                    final_sel[slot] = sel[slot]
        self._start(admissions, final_sel)

    def _maybe_finish(self, slot: int, tok: int):
        req = self.slot_req[slot]
        if req is None:
            return
        if (req.eos_id is not None and tok == req.eos_id) or len(
            req.generated
        ) >= req.max_new_tokens:
            req.done = True
            req.finished_at = time.perf_counter()
            self._finish(req)
            self.slot_req[slot] = None
            self.slot_len[slot] = 0
            self._release_blocks(slot)

    def step(self):
        t_step = time.perf_counter()
        self._expire_and_cancel()
        try:
            self._step_inner()
        finally:
            self._last_step_s = time.perf_counter() - t_step

    def _step_inner(self):
        # 1. Admit queued requests into free slots, all in one forward. The
        #    slots' state must be current: an in-flight dispatch drains first.
        if self.queue and (
            any(r is None for r in self.slot_req) or self._inflight is not None
        ):
            self._drain_inflight()
            admissions = []
            for slot in range(self.slots):
                if self.slot_req[slot] is None and self.queue:
                    admissions.append((slot, self.queue.popleft()))
            if admissions:
                self._admit(admissions)
                self._dev_state = None  # host state is now authoritative
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            self._drain_inflight()
            return
        # 2a. Fused k-step decode when there is KV room (a margin of 2k when
        #     pipelining: the host's lengths lag one dispatch).
        k = self.steps_per_dispatch
        margin = 2 * k if self.pipeline_dispatch else k
        if k > 1 and all(self.slot_len[s] + margin < self.capacity - 1 for s in active):
            if self.pipeline_dispatch and any(
                req.max_new_tokens - len(req.generated) > k
                for req in (self.slot_req[s] for s in active) if req is not None
            ):
                # Issue the next dispatch first, then read the previous one
                # while the card works on the new one.
                prev, self._inflight = self._inflight, None
                self._issue_multi(from_host=self._dev_state is None)
                self._drain_record(prev)
                return
            # Serial dispatches (the tail of a request, or no pipelining),
            # still chained on the device.
            self._drain_inflight()
            # The drain may have finished requests (host bookkeeping lagged
            # one dispatch).
            active = [s for s in range(self.slots) if self.slot_req[s] is not None]
            if not active:
                return
            d = 1
            if self.dispatches_per_drain > 1:
                remaining = min(self.slot_req[s].max_new_tokens
                                - len(self.slot_req[s].generated) for s in active)
                room = min((self.capacity - 2 - int(self.slot_len[s])) // k for s in active)
                d = max(1, min(self.dispatches_per_drain, -(-remaining // k), room))
            recs = []
            for _ in range(d):
                self._issue_multi(from_host=self._dev_state is None)
                recs.append(self._inflight)
                self._inflight = None
            for rec in recs:
                self._drain_record(rec)
            return
        # 2b. One decode step for every slot from the host state (idle
        #     slots compute garbage into their own rows, overwritten at the
        #     next admission).
        self._drain_inflight()
        lens = self._to_device(self.slot_len)
        # Deferred graphs: a one-row window, committed right away.
        step = self._zero_recents(1) if self.deferred_kv else None
        out, self.caches = self._forward(
            self.caches, self.slot_last_tok[:, None], lens, self.slot_len[:, None],
            step=step,
        )
        if self.deferred_kv:
            self._commit_recent(lens)
        if self.greedy_on_device:
            toks = out.cpu().numpy()[active, 0]
        else:
            toks = self._host_sample(out[:, 0].cpu().numpy()[active])
        self.steps += 1
        for tok, slot in zip(toks, active):
            req = self.slot_req[slot]
            req.generated.append(int(tok))
            self.slot_len[slot] += 1
            self.slot_last_tok[slot] = int(tok)
            self.decode_tokens += 1
            if self.slot_len[slot] >= self.capacity - 1:
                req.done = True  # out of KV room
            self._maybe_finish(slot, int(tok))
