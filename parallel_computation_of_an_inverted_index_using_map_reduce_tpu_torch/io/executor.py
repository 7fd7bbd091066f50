"""Pipelined window executor: overlap read, tokenize, and emit.

The reference interleaves read and scan serially inside each mapper
(main.c:97-116).  Here a dedicated reader thread fills window arenas
from a recycling ring while the consumer runs the GIL-releasing native
scan on the previous window, and the final emit happens once at the
end — a read → tokenize → emit pipeline across windows instead of
serial whole-corpus phases.  On a single core the win is the removed
copies; with spare cores the read genuinely hides behind the scan.

Failure semantics (faults.py): the reader thread has an explicit
lifecycle — :meth:`PipelinedWindowReader.close` joins it with a
timeout (context-manager exit does the same), and the consumer side
runs a watchdog so a reader that dies silently raises
:class:`ReaderDied` and one that hangs raises :class:`ReaderHang`
instead of deadlocking the scan forever.  Documents the reader skips
after exhausting their retry budget land in the reader's
:attr:`~PipelinedWindowReader.report`.
"""

from __future__ import annotations

import queue
import threading
import time

from .. import faults
from .arena import WindowArena
from .reader import read_window_into


class ReaderDied(RuntimeError):
    """The reader thread exited without delivering a result or an
    exception — the fire-and-forget daemon failure mode."""


class ReaderHang(RuntimeError):
    """The reader thread is alive but made no progress within the
    watchdog window (hung filesystem / device)."""


class PipelinedWindowReader:
    """Iterate filled :class:`WindowArena` s, reading ahead on a thread.

    ``depth`` is the prefetch distance (arena ring holds ``depth + 1``
    buffers: up to ``depth`` filled ahead plus the one being consumed).
    The consumer MUST hand each arena back via :meth:`recycle` once the
    scan is done with its views — that is what bounds memory and what
    the reader blocks on.  Reader exceptions re-raise in the consumer;
    abandoning the iterator mid-loop unblocks and stops the reader
    (same stop-event contract as corpus.manifest.prefetch_document_ranges),
    and :meth:`close` — also the context-manager exit — joins the
    thread so no daemon leaks past the loop's lifetime.

    ``watchdog_s`` bounds how long the consumer waits for the next
    window with the reader thread still alive before raising
    :class:`ReaderHang` (None disables); a reader thread that died
    without posting anything raises :class:`ReaderDied` immediately.

    ``read_wait_s`` / ``consume_wait_s`` accumulate the time the reader
    sat blocked on a free arena and the consumer sat blocked on a filled
    one — the pipeline-bubble split of the stage report.  Each
    counter is written by exactly one thread (reader / consumer), so
    per-reader instances are race-free and the multi-worker path merges
    them by plain summation.

    ``windows`` is either a concrete window list (read in plan order)
    or a shared :class:`~..corpus.scheduler.StealQueue`: then each of K
    readers pulls the next undrained window when it has a free arena —
    the work-stealing schedule that keeps fast workers busy past a slow
    disk stripe.  Fault hooks fire on the window's GLOBAL plan index in
    both modes, so injection specs mean the same thing at any K.
    """

    def __init__(self, manifest, windows, depth: int = 2,
                 byte_capacity: int = 1 << 21, doc_capacity: int = 256,
                 arenas: list[WindowArena] | None = None,
                 watchdog_s: float | None = 30.0,
                 policy: "faults.RetryPolicy | None" = None,
                 report: "faults.DegradationReport | None" = None,
                 worker: int | None = None,
                 trace=None):
        self._manifest = manifest
        # a shared StealQueue (duck-typed on pop_window) or a plan list
        self._queue = windows if hasattr(windows, "pop_window") else None
        self._windows = [] if self._queue is not None else list(windows)
        # lease attribution under the steal-queue schedule: pops are
        # charged to this worker id so a worker death can requeue
        # exactly its windows (scheduler.StealQueue.fail_worker)
        self._worker = worker
        # optional obs.chrometrace.TraceEvents collector (--trace-out):
        # the reader thread records one "read" span per window
        self._trace = trace
        self._trace_tid = 100 + (worker or 0)  # chrometrace.READER_BASE
        self._depth = max(int(depth), 1)
        self._watchdog_s = watchdog_s
        self.policy = policy if policy is not None else faults.default_policy()
        self.report = report if report is not None else faults.current_report()
        self._ready: queue.Queue = queue.Queue()
        self._free: queue.Queue = queue.Queue()
        if arenas is None:
            arenas = [WindowArena(byte_capacity=byte_capacity,
                                  doc_capacity=doc_capacity)
                      for _ in range(self._depth + 1)]
        self.arenas = arenas  # caller may recycle the ring across runs
        for a in arenas:
            self._free.put(a)
        self._done = object()
        self._stop = threading.Event()
        self.read_wait_s = 0.0     # owned by: reader thread
        self.read_busy_s = 0.0     # owned by: reader thread
        self.consume_wait_s = 0.0  # owned by: consumer thread
        # Reading starts NOW, not at first iteration: the first window
        # has nothing to hide behind once consumption starts, so let it
        # fill while the caller sets up its scan state.
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _get(self, q: queue.Queue):
        # bounded get that gives up when the other side is gone, so
        # neither thread can deadlock holding ring buffers
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    def _iter_windows(self):
        """(global_index, (lo, hi)) pairs from the plan list or, under
        the multi-worker schedule, whatever the shared queue still
        holds — each pop is this reader 'stealing' the next window."""
        if self._queue is None:
            yield from enumerate(self._windows, start=1)
            return
        while True:
            if self._worker is not None:
                item = self._queue.pop_window(worker=self._worker)
            else:
                item = self._queue.pop_window()
            if item is None:
                return
            yield item

    def _reader(self) -> None:
        try:
            for wi, (lo, hi) in self._iter_windows():
                inj = faults.active()
                if inj is not None:
                    inj.on_reader_window(wi)
                t0 = time.perf_counter()
                arena = self._get(self._free)
                self.read_wait_s += time.perf_counter() - t0
                if arena is None:
                    return
                t0 = time.perf_counter()
                read_window_into(self._manifest, lo, hi, arena,
                                 policy=self.policy, report=self.report)
                t1 = time.perf_counter()
                self.read_busy_s += t1 - t0
                if self._trace is not None:
                    self._trace.span("read", t0, t1,
                                     tid=self._trace_tid,
                                     args={"window": wi})
                # the consumer needs the global plan index to ack the
                # lease (and the audit ledger keys on it)
                arena.window_index = wi
                self._ready.put(arena)
                # window wi is now fully read and handed downstream —
                # the crash-injection boundary the SIGKILL e2e tests
                # aim at (same global numbering at any worker count)
                if inj is not None:
                    inj.on_window_boundary(wi)
            self._ready.put(self._done)
        except faults.ReaderThreadDeath:
            # injected silent death: exit WITHOUT posting, so the
            # consumer watchdog — not this handler — must catch it
            return
        except BaseException as e:  # surfaced on the consumer side
            self._ready.put(e)

    def recycle(self, arena: WindowArena) -> None:
        """Return a consumed arena to the ring (MUST be called once per
        yielded arena, after the native scan no longer reads its views)."""
        self._free.put(arena)

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the reader and join its thread (idempotent).

        Returns True when the thread exited within ``timeout``.  The
        stop event unblocks a reader waiting on a free arena; a reader
        stuck inside a hung read() can outlive the join — the False
        return (plus the daemon flag) means it can never block process
        exit, only linger.
        """
        self._stop.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def __enter__(self) -> "PipelinedWindowReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _next_item(self):
        """Watchdog get: poll the ready queue, noticing a dead or hung
        reader instead of blocking forever."""
        t0 = time.perf_counter()
        while True:
            try:
                item = self._ready.get(timeout=0.05)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise ReaderDied(
                        "reader thread exited without delivering a "
                        "window or an error (see faults.py "
                        "reader-death)") from None
                waited = time.perf_counter() - t0
                if (self._watchdog_s is not None
                        and waited > self._watchdog_s):
                    raise ReaderHang(
                        f"reader made no progress in {waited:.1f}s "
                        "(watchdog_s exceeded); a hung filesystem "
                        "would otherwise deadlock the scan") from None
        self.consume_wait_s += time.perf_counter() - t0
        return item

    def __iter__(self):
        try:
            while True:
                item = self._next_item()
                if item is self._done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()
