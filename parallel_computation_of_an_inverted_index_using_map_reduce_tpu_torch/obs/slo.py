"""Declarative SLOs + multi-window burn rates over the rolling SLIs.

Two objectives ship by default, both against ``MRI_OBS_SLO_TARGET``:

* **availability** — 1 − (errors + sheds + deadline misses) /
  admission attempts, per rolling window.  "Bad" counts internal
  errors, admission sheds, draining rejections and expired deadlines;
  client-caused ``bad_request`` lines are the client's fault and do
  not burn the serving budget.
* **latency** — the fraction of data requests answered within
  ``MRI_OBS_SLO_LATENCY_MS``, interpolated from the windowed request
  histogram.

The burn rate per window is the standard multi-window form:
``(1 - ratio) / (1 - target)`` — 1.0 means the error budget burns
exactly at the objective's rate; a 10s burn ≫ 1 with a calm 5m burn
is a spike, both elevated is an outage.  A window with no events
reports ratio 1.0 / burn 0.0: an idle daemon is not failing.

Surfaced three ways by the daemon: the ``slo`` admin op, the ``slo``
block inside ``stats``, and ``mri_slo_*`` gauges in the Prometheus
exposition.  Stdlib-only by design.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils import envknobs
from . import metrics as obs_metrics
from . import windows as obs_windows

LATENCY_ENV = "MRI_OBS_SLO_LATENCY_MS"
TARGET_ENV = "MRI_OBS_SLO_TARGET"

#: availability inputs, in daemon counter-name form
_TOTAL = "mri_serve_requests_total"
_BAD = ("mri_serve_internal_errors_total",
        "mri_serve_shed_total",
        "mri_serve_draining_rejected_total",
        "mri_serve_deadline_expired_total")
_LATENCY_HIST = "mri_serve_request_seconds"


def slo_target() -> float:
    return envknobs.get(TARGET_ENV)


def slo_latency_ms() -> float:
    return envknobs.get(LATENCY_ENV)


@dataclass(frozen=True)
class SLO:
    """One declarative objective: a named good-event fraction."""

    name: str
    target: float
    threshold_ms: float | None = None  # latency SLOs only

    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


def default_slos() -> tuple:
    t = slo_target()
    return (SLO("availability", t),
            SLO("latency", t, threshold_ms=slo_latency_ms()))


class SLOTracker:
    """Window math over a :class:`RollingWindows` for a set of SLOs.

    The metric names default to the daemon-wide families; per-tenant
    trackers pass their own lane's names (``total``/``bad``/
    ``extra_total``/``latency_hist``) and reuse the same math.
    """

    def __init__(self, windows: obs_windows.RollingWindows, slos=None, *,
                 total: str = _TOTAL, bad=_BAD,
                 extra_total=("mri_serve_shed_total",
                              "mri_serve_draining_rejected_total"),
                 latency_hist: str = _LATENCY_HIST):
        self.windows = windows
        self.slos = tuple(slos) if slos is not None else default_slos()
        self._total = total
        self._bad = tuple(bad)
        # sheds/rejections never reach the requests counter: the
        # denominator is every admission attempt the window saw
        self._extra_total = tuple(extra_total)
        self._latency_hist = latency_hist

    def _window_point(self, slo: SLO, span: float) -> dict:
        if slo.threshold_ms is None:
            counts = self.windows.counts(span)
            bad = sum(counts.get(n, 0) for n in self._bad)
            total = (counts.get(self._total, 0)
                     + sum(counts.get(n, 0) for n in self._extra_total))
            ratio = 1.0 if total <= 0 else max(
                0.0, 1.0 - bad / total)
            point = {"total": total, "bad": bad}
        else:
            total = self.windows.hist_count(self._latency_hist, span)
            frac = self.windows.good_fraction(
                self._latency_hist, span, slo.threshold_ms / 1e3)
            ratio = 1.0 if frac is None else frac
            point = {"total": total}
        point["ratio"] = round(ratio, 6)
        point["burn"] = round((1.0 - ratio) / slo.budget(), 4)
        return point

    def report(self) -> dict:
        """The ``slo`` admin-op / stats payload."""
        out = {}
        for slo in self.slos:
            entry = {"target": slo.target}
            if slo.threshold_ms is not None:
                entry["threshold_ms"] = slo.threshold_ms
            entry["windows"] = {
                label: self._window_point(slo, span)
                for label, span in obs_windows.WINDOWS}
            out[slo.name] = entry
        return out

    def set_gauges(self, registry: obs_metrics.Registry) -> None:
        """Refresh the ``mri_slo_*`` gauges (called at scrape time)."""
        for name, entry in self.report().items():
            for label, point in entry["windows"].items():
                registry.gauge(
                    f"mri_slo_{name}_ratio_{label}").set(point["ratio"])
                registry.gauge(
                    f"mri_slo_{name}_burn_{label}").set(point["burn"])
