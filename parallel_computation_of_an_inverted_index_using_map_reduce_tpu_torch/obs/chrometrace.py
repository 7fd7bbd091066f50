"""Chrome ``trace_event`` export for the build pipeline.

A build with ``--trace-out FILE`` writes its timeline as a trace
loadable in ``chrome://tracing`` / Perfetto: one complete ("X"-phase)
span per event, timestamped off ``time.perf_counter``.  The JAX
package's host backend records its reads, window scans, emit ranges,
merge and artifact pack here; the device plans (all this package has
yet) write the same sparse trace the JAX device plans write, holding
the main thread's name only.

Thread ids follow a fixed scheme so lanes sort sensibly:
``MAIN``=0, scan worker *w* = 1+w, reader *w* = 100+w, reducer *r* =
200+r.  :meth:`TraceEvents.name_thread` attaches the human-readable
lane names via ``"M"`` metadata events.
"""

from __future__ import annotations

import json
import os
import threading

MAIN = 0
SCAN_BASE = 1
READER_BASE = 100
REDUCE_BASE = 200


class TraceEvents:
    """Thread-safe collector of complete spans; write() emits the
    ``{"traceEvents": [...]}`` JSON Chrome and Perfetto load."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []  # guarded by: self._lock
        self._names: dict[int, str] = {}  # guarded by: self._lock

    def name_thread(self, tid: int, name: str) -> None:
        with self._lock:
            self._names[tid] = name

    def span(self, name: str, t0: float, t1: float, *, tid: int = MAIN,
             args: dict | None = None) -> None:
        """One complete span; t0/t1 are ``time.perf_counter`` seconds."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": t0 * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": 0,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def count(self, name: str | None = None) -> int:
        with self._lock:
            if name is None:
                return len(self._events)
            return sum(1 for e in self._events if e["name"] == name)

    def write(self, path: str) -> None:
        """Write the trace JSON (timestamps rebased to start near 0)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            names = dict(self._names)
        base = min((e["ts"] for e in events), default=0.0)
        for e in events:
            e["ts"] = round(e["ts"] - base, 3)
            e["dur"] = round(e["dur"], 3)
        meta = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "mri build"},
        }]
        for tid in sorted(names):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": names[tid]},
            })
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
               "otherData": {"pid": os.getpid()}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, separators=(",", ":"))
        os.replace(tmp, path)
