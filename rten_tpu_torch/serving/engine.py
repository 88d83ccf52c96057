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

Not ported (raise ``NotImplementedError``, naming the ROADMAP.md item):
shared prefix (flat and paged), chunked prefill, LoRA, deferred KV, host or
device sampling, ``pipeline_dispatch`` and ``dispatches_per_drain > 1``.
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
        if any(self.g.node_name(n).startswith(("recent.", "lora.", "slot_adapter"))
               for n in self.g.input_ids):
            _unsupported("deferred KV and multi-LoRA graphs", 9)
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
        self.in_ids = {
            n: self.g.find_node(n)
            for n in ("input_ids", "past_lens", "position_ids")
        }
        self.out_ids = [self.g.find_node("next_token")] + [
            self.g.find_node(n) for n in self.present_names
        ]

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

    def _forward(self, caches, ids, lens, pos, last_pos, table=None):
        """One model run over all slot rows; the caches are updated in
        place. Paged graphs read the block table ``table`` (the engine's
        own by default). Returns (next_token [slots, 1], presents)."""
        feed = {
            self.in_ids["input_ids"]: ids,
            self.in_ids["past_lens"]: lens,
            self.in_ids["position_ids"]: pos,
            self.last_pos_id: last_pos,
        }
        if self.paged:
            feed[self._bt_nid] = self._bt_sync() if table is None else table
        feed.update(zip(self.cache_ids, caches))
        outs = self.executor.run(feed, self.out_ids, donate=self.cache_ids)
        return outs[0], list(outs[1:])

    def _multi_step(self, k: int, toks: torch.Tensor, lens: torch.Tensor):
        """k greedy decode steps chained on the device: [slots] tokens and
        lengths in, tokens [slots, k] out. Every slot advances."""
        zeros = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        seq = []
        for _ in range(k):
            nt, self.caches = self._forward(
                self.caches, toks[:, None], lens, lens[:, None], zeros
            )
            toks = nt[:, 0].to(torch.int32)
            lens = lens + 1
            seq.append(toks)
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
        if self.paged:
            table = np.zeros_like(self.block_table)
            for slot, _ in admissions:
                table[slot] = self.block_table[slot]
            nt, self.caches = self._forward(self.caches, *args, self._to_device(table))
        else:
            nt, fresh = self._forward(self._zero_caches(), *args)
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
        nt, self.caches = self._forward(
            self.caches,
            self._to_device(self.slot_last_tok[:, None]),
            self._to_device(self.slot_len),
            self._to_device(self.slot_len[:, None]),
            zeros,
        )
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
