"""Rolling-window SLIs: snapshot-diffed off the cumulative registry.

Every number the obs layer accumulates is cumulative-since-start; an
operator (and the SLO layer) needs *current* rates and quantiles.  The
:class:`RollingWindows` aggregator gets them with **zero new hot-path
feed sites**: a sampler thread wakes every ``MRI_OBS_SAMPLE_MS`` and
diffs the tracked counters and histograms against its previous
snapshot, appending one per-period bucket of deltas to a bounded ring.
Rolling rates, latency quantiles and threshold fractions over the
10s / 1m / 5m windows are then pure reads over the ring.

Histogram buckets are stored in cumulative-delta form (the elementwise
difference of two ``cumulative_counts()`` snapshots), so summing
buckets over a window directly yields the window's cumulative
histogram — quantiles and "fraction under threshold" interpolate
linearly inside one bucket, exactly like PromQL's
``histogram_quantile``.

Stdlib-only by design: the sampler must be importable (and priceable)
without torch or numpy.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils import envknobs
from . import metrics as obs_metrics

SAMPLE_ENV = "MRI_OBS_SAMPLE_MS"

#: the rolling windows every SLI surface reports, label -> span seconds
WINDOWS = (("10s", 10.0), ("1m", 60.0), ("5m", 300.0))
_MAX_SPAN = max(span for _label, span in WINDOWS)


def sample_period_s() -> float:
    return envknobs.get(SAMPLE_ENV) / 1e3


class _Bucket:
    __slots__ = ("ts", "counters", "hists")

    def __init__(self, ts: float, counters: dict, hists: dict):
        self.ts = ts
        self.counters = counters  # name -> delta
        self.hists = hists        # name -> (d_count, d_sum, d_cum tuple)


class RollingWindows:
    """Per-period delta ring over a :class:`obs.metrics.Registry`.

    ``counters`` / ``histograms`` name the registry series to track;
    they are get-or-created up front so the sampler never races metric
    creation.  :meth:`sample` is public so tests (and the pricing
    bench) can tick it deterministically without the thread.
    """

    def __init__(self, registry: obs_metrics.Registry,
                 counters=(), histograms=(),
                 period_s: float | None = None,
                 clock=time.monotonic):
        self.registry = registry
        self.period_s = float(period_s if period_s is not None
                              else sample_period_s())
        self._clock = clock
        self._counters = {n: registry.counter(n) for n in counters}
        self._hists = {n: registry.histogram(n) for n in histograms}
        self._lock = threading.Lock()
        maxlen = int(_MAX_SPAN / self.period_s) + 2
        self._ring: deque = deque(maxlen=maxlen)  # guarded by: self._lock
        self._prev_c: dict = {}    # guarded by: self._lock
        self._prev_h: dict = {}    # guarded by: self._lock
        self._start = self._clock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # seed the baseline snapshot so the first tick diffs cleanly
        with self._lock:
            self._snapshot_locked()

    def _snapshot_locked(self) -> tuple[dict, dict]:
        """Read cumulative state and return (counter, hist) deltas
        against the previous snapshot, updating it in place."""
        d_c, d_h = {}, {}
        for name, c in self._counters.items():
            cur = c.value
            d_c[name] = cur - self._prev_c.get(name, 0)
            self._prev_c[name] = cur
        for name, h in self._hists.items():
            cum = tuple(h.cumulative_counts())
            total = h.sum
            p_cum, p_sum = self._prev_h.get(
                name, ((0,) * len(cum), 0.0))
            d_h[name] = (cum[-1] - p_cum[-1], total - p_sum,
                         tuple(a - b for a, b in zip(cum, p_cum)))
            self._prev_h[name] = (cum, total)
        return d_c, d_h

    def sample(self) -> None:
        """One sampler tick: append the delta bucket for this period."""
        now = self._clock()
        with self._lock:
            d_c, d_h = self._snapshot_locked()
            self._ring.append(_Bucket(now, d_c, d_h))

    def track(self, counters=(), histograms=()) -> None:
        """Register additional registry series after construction —
        per-tenant lanes appear lazily on a tenant's first request.
        New series are seeded at their *current* cumulative value so
        the next tick diffs cleanly (no phantom first-bucket spike);
        already-tracked names are no-ops."""
        with self._lock:
            for n in counters:
                if n in self._counters:
                    continue
                c = self.registry.counter(n)
                self._counters[n] = c
                self._prev_c[n] = c.value
            for n in histograms:
                if n in self._hists:
                    continue
                h = self.registry.histogram(n)
                self._hists[n] = h
                self._prev_h[n] = (tuple(h.cumulative_counts()), h.sum)

    def tracks(self, name: str) -> bool:
        with self._lock:
            return name in self._counters or name in self._hists

    # -- sampler thread -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mri-obs-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — sampler must survive races
                pass

    # -- window reads ---------------------------------------------------

    def _buckets(self, window_s: float, now: float) -> list:
        cutoff = now - window_s - self.period_s / 2
        return [b for b in self._ring if b.ts > cutoff]

    def span(self, window_s: float) -> float:
        """Effective denominator: the window, clamped to process age
        (so early-life rates aren't diluted by an empty prefix)."""
        return max(self.period_s,
                   min(float(window_s), self._clock() - self._start))

    def counts(self, window_s: float) -> dict:
        """Summed counter deltas over the window."""
        now = self._clock()
        with self._lock:
            out = dict.fromkeys(self._counters, 0)
            for b in self._buckets(window_s, now):
                for name, d in b.counters.items():
                    out[name] += d
        return out

    def rate(self, name: str, window_s: float) -> float:
        """Events per second for one counter over the window."""
        return self.counts(window_s).get(name, 0) / self.span(window_s)

    def _hist_cum(self, name: str, window_s: float):
        """(cumulative bucket counts, count, sum) over the window."""
        h = self._hists[name]
        now = self._clock()
        cum = [0] * (len(h.bounds) + 1)
        count, total = 0, 0.0
        with self._lock:
            for b in self._buckets(window_s, now):
                entry = b.hists.get(name)
                if entry is None:
                    continue
                d_count, d_sum, d_cum = entry
                count += d_count
                total += d_sum
                for i, d in enumerate(d_cum):
                    cum[i] += d
        return cum, count, total

    def hist_count(self, name: str, window_s: float) -> int:
        return self._hist_cum(name, window_s)[1]

    def quantile(self, name: str, window_s: float,
                 p: float) -> float | None:
        """Windowed quantile in the histogram's native unit (seconds),
        linearly interpolated inside the landing bucket; ``None`` when
        the window saw no observations."""
        cum, count, _ = self._hist_cum(name, window_s)
        if count <= 0:
            return None
        bounds = self._hists[name].bounds
        rank = max(1e-12, (p / 100.0) * count)
        prev = 0
        for i, c in enumerate(cum):
            if c >= rank:
                if i >= len(bounds):      # +Inf bucket: clamp
                    return float(bounds[-1])
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i]
                frac = (rank - prev) / max(1, c - prev)
                return lo + (hi - lo) * frac
            prev = c
        return float(bounds[-1])

    def good_fraction(self, name: str, window_s: float,
                      threshold_s: float) -> float | None:
        """Fraction of windowed observations at or under the
        threshold (the latency-SLO SLI); ``None`` with no samples."""
        cum, count, _ = self._hist_cum(name, window_s)
        if count <= 0:
            return None
        bounds = self._hists[name].bounds
        prev_c, lo = 0, 0.0
        for i, hi in enumerate(bounds):
            if threshold_s <= hi:
                inside = cum[i] - prev_c
                frac = (threshold_s - lo) / max(hi - lo, 1e-30)
                le = prev_c + inside * min(1.0, max(0.0, frac))
                return min(1.0, le / count)
            prev_c, lo = cum[i], hi
        return 1.0
