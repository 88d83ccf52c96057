"""Op-level profiler (the port of ``rten_tpu/runtime/profiler.py``; rten
src/timing.rs:386-527).

``Executor.profile_run`` walks the plan as ``run`` does, synchronizing the
device after each op and recording its wall time, which maps 1:1 to graph
ops like the reference's per-op TimingRecord. The synchronization keeps
the card from overlapping ops, so the sum is an upper bound of a plain
run's time; relative costs and shape breakdowns are what it is for.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import List, Tuple


@dataclasses.dataclass
class TimingRecord:
    op_type: str
    name: str
    input_shapes: Tuple
    elapsed_s: float


class Profiler:
    def __init__(self):
        self.records: List[TimingRecord] = []

    def add(self, op_type, name, input_shapes, elapsed_s):
        self.records.append(TimingRecord(op_type, name, tuple(input_shapes), elapsed_s))

    def total_s(self) -> float:
        return sum(r.elapsed_s for r in self.records)

    def report(self, sort: str = "time", by_shape: bool = False, limit: int = 30) -> str:
        """Aggregate report like rten's (timing.rs:482): % per op type,
        optional per-shape breakdown."""
        total = self.total_s() or 1e-12
        lines = [f"total {total * 1e3:.2f} ms across {len(self.records)} op runs"]
        agg = defaultdict(lambda: [0.0, 0])
        for r in self.records:
            key = (r.op_type, r.input_shapes) if by_shape else (r.op_type,)
            agg[key][0] += r.elapsed_s
            agg[key][1] += 1
        items = sorted(
            agg.items(),
            key=(lambda kv: -kv[1][0]) if sort == "time" else (lambda kv: kv[0]),
        )
        for key, (secs, count) in items[:limit]:
            label = key[0] if not by_shape else f"{key[0]} {list(key[1])}"
            lines.append(
                f"  {label:<40} {secs * 1e3:9.2f} ms  {100 * secs / total:5.1f}%  x{count}"
            )
        return "\n".join(lines)
