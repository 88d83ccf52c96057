"""Speculative decoding for the continuous-batching engine (the port of
``rten_tpu/serving/speculative.py``).

A small DRAFT model proposes gamma tokens per slot; the TARGET model
verifies all of them in ONE S = gamma + 1 forward against its static cache
and accepts the longest matching prefix (greedy acceptance: target argmax
== draft token). The output tokens are exactly the target's greedy
sequence: speculation changes latency, never content.

* The slot caches are read only up to each slot's ``past_lens``, so a
  rejection costs nothing: rows written past the accepted length are dead,
  and ``lens`` not advancing is the rollback.
* One round per step: the draft's catch-up step, gamma draft steps, the
  target's verify and the acceptance, all on the device; the host reads
  the [slots, gamma + 1] tokens and the per-slot counts once.

Cache-sync invariant (per slot, before every round): the target cache
holds L rows and the pending token is not cached; the draft cache holds L
or L - 1 rows, the only row it may miss being the token at position L - 1
(``prev``, missed when a whole round was accepted). Each round recomputes
that row first (idempotent when present: same token, same prefix, same
KV).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .engine import ContinuousBatchingEngine, Request


class SpeculativeEngine(ContinuousBatchingEngine):
    """Greedy continuous batching with draft-model speculation.

    ``draft_model`` must share the target's vocabulary and be a
    static-cache serving graph; neither graph may be deferred, and the
    target must run its lm_head over every row (``gather_last=False``).
    ``gamma`` draft tokens are verified per round, so a round emits 1 to
    gamma + 1 tokens per slot.
    """

    def __init__(self, model, draft_model, *, gamma: int = 4, **kw):
        kw.setdefault("greedy_on_device", True)
        # Refuse what the configuration cannot honour instead of silently
        # discarding it.
        if kw.pop("device_sampler", None) is not None:
            raise ValueError(
                "speculative decoding is greedy-only; device_sampler is "
                "not supported"
            )
        if kw.pop("steps_per_dispatch", 1) != 1:
            raise ValueError("steps_per_dispatch is owned by speculation (use gamma)")
        super().__init__(model, steps_per_dispatch=1, **kw)
        if self.deferred_kv:
            raise ValueError("speculative decoding needs deferred_kv=False")
        if self.last_pos_id is not None:
            # The verify needs the argmax at all gamma + 1 positions; a
            # gather_last head emits one row per slot.
            raise ValueError(
                "speculative decoding needs gather_last=False graphs "
                "(the verify step consumes every position's logits)"
            )
        if self.paged:
            raise ValueError("speculative decoding does not support paged-KV graphs")
        if not self.greedy_on_device:
            raise ValueError("speculative decoding is greedy-only (needs "
                             "the graph's next_token output)")
        self.draft = draft_model
        self.gamma = int(gamma)
        dg = draft_model.graph
        if any(dg.node_name(n).startswith("recent.") for n in dg.input_ids):
            raise ValueError("draft graph must be built with deferred_kv=False")

        # The draft's caches, discovered from its graph like the target's.
        d_cache_names = [dg.node_name(n) for n in dg.input_ids
                         if dg.node_name(n).startswith("past_key_values.")]
        self.d_cache_ids = [dg.find_node(n) for n in d_cache_names]
        self._d_cache_alloc = [
            ((self.slots,) + tuple(dg.nodes[nid].shape[1:]), dg.nodes[nid].dtype.torch_dtype)
            for nid in self.d_cache_ids
        ]
        self.d_in_ids = {n: dg.find_node(n)
                         for n in ("input_ids", "past_lens", "position_ids")}
        self.d_out_ids = [dg.find_node("next_token")] + [
            dg.find_node("present." + n[len("past_key_values."):]) for n in d_cache_names
        ]
        if self.d_out_ids[0] is None:
            raise ValueError("draft graph lacks a next_token output")
        self.draft_caches = self._zero_draft_caches()
        # The last ACCEPTED token per slot (the catch-up row's token).
        self.slot_prev_tok = np.zeros(self.slots, np.int32)
        # Speculation telemetry.
        self.spec_rounds = 0
        self.spec_accepted = 0

    def _zero_draft_caches(self) -> List[torch.Tensor]:
        return [torch.zeros(shape, dtype=dt, device=self.draft.device)
                for shape, dt in self._d_cache_alloc]

    def _draft_forward(self, caches, ids, lens, pos):
        """One draft run over all slot rows, its caches updated in place.
        Returns (next_token [slots, S], presents)."""
        feed = {self.d_in_ids["input_ids"]: ids, self.d_in_ids["past_lens"]: lens,
                self.d_in_ids["position_ids"]: pos}
        feed.update(zip(self.d_cache_ids, caches))
        outs = self.draft.executor.run(feed, self.d_out_ids, donate=self.d_cache_ids)
        return outs[0], list(outs[1:])

    def _draft_step(self, toks, lens):
        out, self.draft_caches = self._draft_forward(
            self.draft_caches, toks[:, None], lens, lens[:, None])
        return out[:, 0].to(torch.int32)

    def _spec_round(self, toks, prevs, lens):
        """One speculation round on the device: (new pending tokens, new
        prevs, new lens, the target's tokens [slots, gamma + 1], the
        accepted count + 1 per slot)."""
        g = self.gamma
        # 1) Draft catch-up: (re)write prev's KV row at lens - 1.
        self._draft_step(prevs, torch.clamp(lens - 1, min=0))
        # 2) gamma draft steps from the pending token.
        tok, ln, drafted = toks, lens, []
        for _ in range(g):
            tok = self._draft_step(tok, ln)
            ln = ln + 1
            drafted.append(tok)
        d = torch.stack(drafted, dim=1)  # [slots, gamma]
        # 3) Target verify: ONE S = gamma + 1 forward over [pending | draft
        #    tokens], writing gamma + 1 rows per slot.
        ids = torch.cat([toks[:, None], d], dim=1)
        pos = lens[:, None] + torch.arange(g + 1, dtype=torch.int32, device=lens.device)[None]
        out, self.caches = self._forward(self.caches, ids, lens, pos)
        t = out.to(torch.int32)  # [slots, gamma + 1] argmax
        # 4) Greedy acceptance: the longest prefix where target == draft.
        #    Accepted positions agree, so the output tokens are the target
        #    row ``t``; count = a + 1 per slot.
        match = (t[:, :g] == d).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(dim=1)  # [slots] 0..gamma
        sl = torch.arange(self.slots, device=t.device)
        new_toks = t[sl, a]
        new_prevs = torch.where(a > 0, t[sl, torch.clamp(a - 1, min=0)], toks)
        return new_toks, new_prevs, lens + a + 1, t, a + 1

    # -- admission ----------------------------------------------------------

    def _admit(self, admissions):
        super()._admit(admissions)  # the target's prefill and first token
        if not admissions:
            return
        # The draft prefills the whole prompt (a shared prefix included)
        # over fresh caches; the admitted rows are copied into its caches.
        T = self._round_up(max(len(r.prompt) for _, r in admissions))
        ids = np.zeros((self.slots, T), np.int32)
        for slot, req in admissions:
            ids[slot, : len(req.prompt)] = req.prompt
        pos = self._positions(0, T)
        _, fresh = self._draft_forward(self._zero_draft_caches(), ids,
                                       np.zeros(self.slots, np.int32), pos)
        rows = torch.as_tensor([s for s, _ in admissions], device=self.draft.device)
        for c, p in zip(self.draft_caches, fresh):
            c.index_copy_(0, rows, p.index_select(0, rows))
        for slot, req in admissions:
            self.slot_prev_tok[slot] = req.prompt[-1]

    def submit(self, prompt, max_new_tokens: int = 64, eos_id=None,
               timeout_s=None) -> Request:
        # A tighter KV bound than the base's: every round writes gamma + 1
        # target rows, and the last may start at len(prompt) + max_new - 1.
        if len(prompt) + max_new_tokens + self.gamma + 1 > self.capacity:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new_tokens}) + "
                f"gamma+1 ({self.gamma + 1}) exceeds KV capacity "
                f"{self.capacity} (speculative dispatches need headroom)"
            )
        return super().submit(prompt, max_new_tokens, eos_id, timeout_s)

    # -- decode --------------------------------------------------------------

    def _step_inner(self):
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
        outs = self._spec_round(self._to_device(self.slot_last_tok),
                                self._to_device(self.slot_prev_tok),
                                self._to_device(self.slot_len))
        toks, prevs, lens, t_seq, counts = (x.cpu().numpy() for x in outs)
        self.steps += 1
        for slot in active:
            req = self.slot_req[slot]
            n = int(counts[slot])
            self.spec_rounds += 1  # one speculation round per active slot
            self.spec_accepted += n
            cut = min(n, req.max_new_tokens - len(req.generated))
            accepted = t_seq[slot, :cut]
            if req.eos_id is not None:
                hits = np.nonzero(accepted == req.eos_id)[0]
                if hits.size:
                    cut = int(hits[0]) + 1
                    accepted = accepted[:cut]
            req.generated.extend(int(x) for x in accepted)
            self.decode_tokens += cut
            if cut == n:
                # The whole round was taken: adopt the device's state.
                self.slot_len[slot] = int(lens[slot])
                self.slot_last_tok[slot] = int(toks[slot])
                self.slot_prev_tok[slot] = int(prevs[slot])
            # else the request finishes below (max_new or eos) and its slot
            # resets.
            self._maybe_finish(slot, int(accepted[-1]) if cut else -1)

    def restart(self) -> List[Request]:
        requeued = super().restart()
        self.draft_caches = self._zero_draft_caches()
        self.slot_prev_tok[:] = 0
        return requeued

    def fail_inflight(self, error: str) -> List[Request]:
        failed = super().fail_inflight(error)
        self.draft_caches = self._zero_draft_caches()
        self.slot_prev_tok[:] = 0
        return failed

    def stats(self) -> Dict:
        s = super().stats()
        s["spec_rounds"] = self.spec_rounds
        s["spec_tokens_per_round"] = (
            self.spec_accepted / self.spec_rounds if self.spec_rounds else 0.0
        )
        return s
