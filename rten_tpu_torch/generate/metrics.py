"""Generation metrics (a copy of ``rten_tpu/generate/metrics.py``; rten
rten-generate/src/metrics.rs:15-95):
tokens/sec with prefill (warmup) separated from steady-state decode."""

from __future__ import annotations

import time
from typing import List, Optional


class Metrics:
    def __init__(self):
        self.prefill_time_s: Optional[float] = None
        self.prompt_tokens: int = 0
        self.step_times_s: List[float] = []
        self._start: Optional[float] = None

    def start_step(self):
        self._start = time.perf_counter()

    def end_prefill(self, prompt_tokens: int):
        self.prefill_time_s = time.perf_counter() - self._start
        self.prompt_tokens = prompt_tokens

    def end_step(self):
        self.step_times_s.append(time.perf_counter() - self._start)

    @property
    def generated_tokens(self) -> int:
        return len(self.step_times_s)

    def tokens_per_sec(self, skip_warmup: int = 1) -> float:
        """Steady-state decode throughput, skipping compile-heavy steps."""
        steps = self.step_times_s[skip_warmup:] or self.step_times_s
        total = sum(steps)
        return len(steps) / total if total > 0 else 0.0

    def ttft_s(self) -> Optional[float]:
        """Time to first token = prefill latency."""
        return self.prefill_time_s

    def report(self) -> str:
        tps = self.tokens_per_sec()
        ttft = self.ttft_s()
        return (
            f"prompt={self.prompt_tokens} tok, ttft={ttft * 1e3:.1f} ms, "
            f"decode={tps:.2f} tok/s ({1e3 / tps if tps else 0:.1f} ms/token), "
            f"generated={self.generated_tokens}"
        )
