"""Chrome ``trace_event`` export for the build pipeline.

A build with ``--trace-out FILE`` writes its timeline as a trace
loadable in ``chrome://tracing`` / Perfetto: one complete ("X"-phase)
span per event.  Every plan's phases are spans (``obs.timing.PhaseTimer``),
the streaming all-device plans add one ``read``, ``pack``, ``scan`` and
``feed`` span per window (on a mesh ``tokenize``, ``exchange`` and
``merge`` inside each ``feed``), every wait of the host on the card is a
``card_wait`` span, and the CLI adds ``manifest`` and ``build``.  The
host backend records its reads, window scans, emit ranges, merge and
artifact pack under the JAX package's span names.

Each span's ``args`` hold its ``parent`` (the name of the innermost span
open on the recording thread, else on the thread that made the
collector, when it is recorded; None at the top) and the ``build`` id
that every span of one collector shares.  Durations come from
``time.perf_counter``; the collector takes one ``(perf_counter,
time.time_ns())`` anchor when it is made and writes
``baseTimeNanoseconds`` with each ``ts`` in µs after it, the convention
of ``torch.profiler``'s ``export_chrome_trace``: ``base + ts`` is Unix
time in both files, so program spans line up with the card's kernels.

Thread ids follow a fixed scheme so lanes sort sensibly:
``MAIN``=0 (named "main" from the start), scan worker *w* = 1+w, reader *w* = 100+w, reducer *r* =
200+r.  :meth:`TraceEvents.name_thread` attaches the human-readable
lane names via ``"M"`` metadata events.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time

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
        self._names: dict[int, str] = {MAIN: "main"}  # guarded by: self._lock
        # open spans by thread ident, innermost last; guarded by: self._lock
        self._open: dict[int, list[str]] = {}
        self._owner = threading.get_ident()
        self._anchor = (time.perf_counter(), time.time_ns())
        self.build = secrets.token_hex(8)

    def name_thread(self, tid: int, name: str) -> None:
        with self._lock:
            self._names[tid] = name

    def innermost(self) -> str | None:
        """The innermost open span of this thread, else of the thread
        that made the collector (a worker's span runs inside its phase)."""
        with self._lock:
            stack = self._open.get(threading.get_ident()) or self._open.get(self._owner)
            return stack[-1] if stack else None

    def enter(self, name: str) -> None:
        """Open ``name`` on this thread: the parent of the spans recorded
        on it until :meth:`leave`."""
        with self._lock:
            self._open.setdefault(threading.get_ident(), []).append(name)

    def leave(self) -> None:
        """Close this thread's innermost open span; record it with
        :meth:`span` after this, so its parent is the span around it."""
        with self._lock:
            self._open[threading.get_ident()].pop()

    def span(self, name: str, t0: float, t1: float, *, tid: int = MAIN,
             args: dict | None = None) -> None:
        """One complete span; t0/t1 are ``time.perf_counter`` seconds.
        Its parent is the innermost span open now."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": t0,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": 0,
            "tid": tid,
            "args": {**(args or {}), "parent": self.innermost(), "build": self.build},
        }
        with self._lock:
            self._events.append(ev)

    def write(self, path: str) -> None:
        """Write the trace JSON: ``ts`` in µs after ``baseTimeNanoseconds``."""
        with self._lock:
            events = [dict(e) for e in self._events]
            names = dict(self._names)
        pc0, ns0 = self._anchor
        for e in events:
            e["ts"] = round((e["ts"] - pc0) * 1e6, 3)
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
               "baseTimeNanoseconds": ns0, "otherData": {"pid": os.getpid()}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, separators=(",", ":"))
        os.replace(tmp, path)
