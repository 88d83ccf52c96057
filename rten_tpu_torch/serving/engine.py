"""Continuous-batching engine (the port of ``rten_tpu/serving/engine.py``,
greedy decoding on the device).

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
  engine's.
* Decode: ``steps_per_dispatch`` greedy steps per dispatch, a plain Python
  loop that keeps tokens and lengths on the device (every slot, live or
  idle, advances its length and writes its KV row, as in the JAX scan) and
  copies the [slots, k] tokens to the host once per dispatch. Tokens and
  lengths chain on the device across dispatches until the next admission.
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
  running and queued request instead.

Not ported (raise ``NotImplementedError``, naming the ROADMAP.md item):
shared prefix (flat and paged), chunked prefill, LoRA, host or device
sampling, ``pipeline_dispatch`` and ``dispatches_per_drain > 1``.
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

from ..generate.sampler import Sampler
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


def _unsupported(what: str, item: int):
    raise NotImplementedError(f"{what}: ROADMAP.md queue 1 item {item}")


class ContinuousBatchingEngine:
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
        device_sampler=None,
        greedy_on_device: bool = False,
        steps_per_dispatch: int = 1,
        dispatches_per_drain: int = 1,
        pipeline_dispatch: bool = False,
        chunked_prefill: bool = False,
        max_queue: Optional[int] = None,
    ):
        self.model = model
        self.executor = model.executor
        self.device = model.device
        self.g = model.graph
        self.slots = slots
        self.capacity = capacity
        self.prefill_bucket = prefill_bucket

        if device_sampler is not None:
            _unsupported("on-device sampling (DeviceSampler)", 6)
        if sampler is not None or not greedy_on_device:
            _unsupported("host sampling from logits", 6)
        if self.g.find_node("next_token") is None:
            _unsupported("graphs without an on-device next_token", 10)
        # Paged KV: block pools plus a per-slot block_table input.
        self._bt_nid = self.g.find_node("block_table")
        self.paged = self._bt_nid is not None
        if chunked_prefill:
            _unsupported("chunked prefill", 9)
        if pipeline_dispatch:
            _unsupported("pipeline_dispatch", 9)
        if dispatches_per_drain != 1:
            _unsupported("dispatches_per_drain > 1", 9)
        if any(self.g.node_name(n).startswith(("lora.", "slot_adapter"))
               for n in self.g.input_ids):
            _unsupported("multi-LoRA graphs", 9)
        self.last_pos_id = self.g.find_node("last_pos")
        if self.last_pos_id is None:
            _unsupported("graphs without last_pos (gather_last=False)", 10)

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
        self.in_ids = {
            n: self.g.find_node(n)
            for n in ("input_ids", "past_lens", "position_ids")
        }
        self.out_ids = [self.g.find_node("next_token")] + [
            self.g.find_node(n) for n in self.present_names
        ]
        # Inputs the model may write in place: the caches and the windows.
        self._donate = self.cache_ids + self.recent_ids

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
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # Device-chained (tokens, lens) of the last dispatch; None when the
        # host bookkeeping is authoritative (after an admission).
        self._dev_state = None

    # -- device helpers ---------------------------------------------------

    def _zero_caches(self) -> List[torch.Tensor]:
        return [torch.zeros(shape, dtype=dtype, device=self.device)
                for shape, dtype in self._cache_alloc]

    def _forward(self, caches, ids, lens, pos, last_pos, table=None, step=None):
        """One model run over all slot rows; the caches (and a deferred
        graph's windows) are updated in place. Paged graphs read the block
        table ``table`` (the engine's own by default); deferred graphs the
        windows ``self._recents`` at ``step`` ([1] int32 on the device).
        Returns (next_token [slots, 1], presents)."""
        feed = {
            self.in_ids["input_ids"]: ids,
            self.in_ids["past_lens"]: lens,
            self.in_ids["position_ids"]: pos,
            self.last_pos_id: last_pos,
        }
        if self.paged:
            feed[self._bt_nid] = self._bt_sync() if table is None else table
        if self.deferred_kv:
            feed[self.step_t_id] = step
            feed.update(zip(self.recent_ids, self._recents))
        feed.update(zip(self.cache_ids, caches))
        outs = self.executor.run(feed, self.out_ids, donate=self._donate)
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
        """k greedy decode steps chained on the device: [slots] tokens and
        lengths in, tokens [slots, k] out. Every slot advances. A deferred
        graph's steps write the windows; the dispatch commits them."""
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        steps = None
        if self.deferred_kv:
            self._zero_recents(k)
            steps = torch.arange(k, dtype=torch.int32, device=self.device)
        lens0 = lens
        seq = []
        for t in range(k):
            nt, self.caches = self._forward(
                self.caches, toks[:, None], lens, lens[:, None], zeros,
                step=None if steps is None else steps[t:t + 1],
            )
            toks = nt[:, 0].to(torch.int32)
            lens = lens + 1
            seq.append(toks)
        if self.deferred_kv:
            self._commit_recent(lens0)
        return toks, lens, torch.stack(seq, dim=1)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- paged-KV block allocator --------------------------------------------

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request must own to cover every position it can write:
        prefill rows 0..P-1, decode rows up to P+max_new-2, plus the fused
        dispatch's overrun (tokens past eos or the budget still write KV;
        bounded by k per dispatch, counted twice as the reference does)."""
        span = min(prompt_len + max_new + 2 * max(self.steps_per_dispatch, 1),
                   self.capacity)
        return -(-span // self.block_size)

    def _reserve_blocks(self, slot: int, n: int) -> bool:
        """Assign n pool blocks to ``slot``; False if the pool is short (the
        caller re-queues the request)."""
        if len(self._free_blocks) < n:
            return False
        blocks = [self._free_blocks.pop() for _ in range(n)]
        self._slot_blocks[slot] = blocks
        self.block_table[slot] = 0
        self.block_table[slot, :n] = blocks
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

    # -- public API ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None) -> Request:
        # Validate here: a bad request must fail at submit time, not crash
        # the serving loop mid-step.
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        if len(prompt) > self.capacity - max_new_tokens:
            raise ValueError(
                f"prompt ({len(prompt)} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds KV capacity {self.capacity}"
            )
        if self.paged:
            need = self._blocks_needed(len(prompt), max_new_tokens)
            if need > self.n_blocks - 1:
                # Could never be admitted, even with an empty pool.
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has "
                    f"{self.n_blocks - 1}"
                )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); retry later"
            )
        req = Request(
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            timeout_s=timeout_s,
            request_id=next(self._req_counter),
            submitted_at=time.perf_counter(),
        )
        self.queue.append(req)
        return req

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
            "last_step_s": self._last_step_s,
        }

    def set_shared_prefix(self, prefix_tokens):
        _unsupported("shared-prefix caching (flat and paged)", 9)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

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
        """Release every slot's blocks and zero the slots' bookkeeping, the
        caches and the deferred windows; tokens and lengths chain from the
        host again."""
        for slot in range(self.slots):
            self._release_blocks(slot)
        self.slot_len[:] = 0
        self.slot_last_tok[:] = 0
        self._dev_state = None
        self.caches = self._zero_caches()
        for windows in self._recent_sets.values():
            for r in windows:
                r.zero_()

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

    # -- internals -----------------------------------------------------------

    def _round_up(self, x: int) -> int:
        m = self.prefill_bucket
        return ((x + m - 1) // m) * m if x else m

    def _admit(self, admissions):
        """Prefill a batch of (slot, request) pairs in ONE forward over all
        slot rows. Slot-major caches: the forward writes fresh zero caches
        and the admitted rows are copied into the live ones. Paged pools:
        each admission first reserves its blocks (FIFO: the first request
        the pool cannot hold goes back to the head of the queue with every
        one behind it), then the forward writes the live pools through a
        table whose other rows point at block 0."""
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
        T = self._round_up(max(len(r.prompt) for _, r in admissions))
        ids = np.zeros((self.slots, T), np.int32)
        last_idx = np.zeros(self.slots, np.int32)
        for slot, req in admissions:
            ids[slot, : len(req.prompt)] = req.prompt
            last_idx[slot] = len(req.prompt) - 1
        pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (self.slots, T))
        args = (self._to_device(ids), self._to_device(np.zeros(self.slots, np.int32)),
                self._to_device(pos), self._to_device(last_idx))
        # Deferred graphs: one-row dummy windows (the prefill writes the
        # caches directly; the windows pass through).
        step = self._zero_recents(1) if self.deferred_kv else None
        if self.paged:
            table = np.zeros_like(self.block_table)
            for slot, _ in admissions:
                table[slot] = self.block_table[slot]
            nt, self.caches = self._forward(self.caches, *args, self._to_device(table), step)
        else:
            nt, fresh = self._forward(self._zero_caches(), *args, step=step)
            rows = self._to_device(np.array([s for s, _ in admissions], np.int64))
            for c, p in zip(self.caches, fresh):
                c.index_copy_(0, rows, p.index_select(0, rows))
        sel = nt[:, 0].cpu().numpy()
        now = time.perf_counter()
        for slot, req in admissions:
            tok = int(sel[slot])
            req.first_token_at = now
            req.generated.append(tok)
            self.slot_req[slot] = req
            self.slot_len[slot] = len(req.prompt)
            self.slot_last_tok[slot] = tok
            self._maybe_finish(slot, tok)

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

    def _dispatch(self, active):
        """One fused k-step dispatch, then the host bookkeeping of its
        tokens (one device -> host copy)."""
        k = self.steps_per_dispatch
        if self._dev_state is None:
            toks = self._to_device(self.slot_last_tok)
            lens = self._to_device(self.slot_len)
        else:
            toks, lens = self._dev_state
        toks, lens, tok_seq = self._multi_step(k, toks, lens)
        self._dev_state = (toks, lens)
        tok_seq = tok_seq.cpu().numpy()
        self.steps += k
        for slot in active:
            req = self.slot_req[slot]
            if req is None:
                continue
            toks_s = tok_seq[slot]
            cut = min(k, req.max_new_tokens - len(req.generated))
            if req.eos_id is not None:
                hits = np.nonzero(toks_s[:cut] == req.eos_id)[0]
                if hits.size:
                    cut = int(hits[0]) + 1
            accepted = toks_s[:cut]
            req.generated.extend(int(t) for t in accepted)
            self.slot_len[slot] += cut
            if cut:
                self.slot_last_tok[slot] = int(accepted[-1])
            self.decode_tokens += cut
            if cut:
                self._maybe_finish(slot, int(accepted[-1]))

    def step(self):
        t_step = time.perf_counter()
        self._expire_and_cancel()
        try:
            self._step_inner()
        finally:
            self._last_step_s = time.perf_counter() - t_step

    def _step_inner(self):
        # 1. Admit queued requests into free slots, all in one forward.
        if self.queue and any(r is None for r in self.slot_req):
            admissions = []
            for slot in range(self.slots):
                if self.slot_req[slot] is None and self.queue:
                    admissions.append((slot, self.queue.popleft()))
            if admissions:
                self._admit(admissions)
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return
        # 2a. Fused k-step decode when there is KV room.
        k = self.steps_per_dispatch
        if k > 1 and all(self.slot_len[s] + k < self.capacity - 1 for s in active):
            self._dispatch(active)
            return
        # 2b. One decode step for every slot from the host state (idle
        #     slots compute garbage into their own rows, overwritten at the
        #     next admission).
        zeros = self._to_device(np.zeros(self.slots, np.int32))
        lens = self._to_device(self.slot_len)
        # Deferred graphs: a one-row window, committed right away.
        step = self._zero_recents(1) if self.deferred_kv else None
        nt, self.caches = self._forward(
            self.caches,
            self._to_device(self.slot_last_tok[:, None]),
            lens,
            self._to_device(self.slot_len[:, None]),
            zeros,
            step=step,
        )
        if self.deferred_kv:
            self._commit_recent(lens)
        toks = nt.cpu().numpy()[active, 0]
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
