"""Daemon watchdog: heartbeat stamps + a stall-detecting monitor.

``healthz`` answers inline from the reader threads by design, which
means a wedged dispatcher looks perfectly healthy from the outside
while every query queues to death.  The watchdog closes that gap:
monitored threads (dispatcher, accept loop) stamp a monotonic
heartbeat each loop iteration — including the idle path, so quiet is
never mistaken for stalled — and a monitor thread fires once per
stall episode when a heartbeat ages past ``MRI_OBS_STALL_MS``:

* bumps ``mri_watchdog_stalls_total``,
* invokes the daemon's ``on_stall`` callback (structured stall event
  + FlightRecorder dump with reason ``stall``), and
* keeps the thread listed in :meth:`stalled` until its heartbeat
  resumes, which is what flips ``healthz`` readiness to ``stalled``
  and back.

``beat()`` is one lock-free float store into a dict slot — cheap
enough for the dispatcher's inner loop.  Stdlib-only by design.
"""

from __future__ import annotations

import threading
import time

from ..utils import envknobs
from . import metrics as obs_metrics

STALL_ENV = "MRI_OBS_STALL_MS"

STALLS_TOTAL = "mri_watchdog_stalls_total"


def stall_ms() -> float:
    return envknobs.get(STALL_ENV)


class Watchdog:
    """Heartbeat registry + monitor thread.

    ``on_stall(name, age_ms)`` runs on the monitor thread, once per
    stall episode; exceptions from it are swallowed — detection must
    never take the monitor down.  ``stall_ms == 0`` disables the
    monitor entirely (``start()`` is a no-op, nothing ever stalls).
    """

    def __init__(self, stall_ms_: float | None = None, on_stall=None,
                 on_recover=None,
                 registry: obs_metrics.Registry | None = None,
                 clock=time.monotonic):
        self.stall_ms = float(stall_ms_ if stall_ms_ is not None
                              else stall_ms())
        self.on_stall = on_stall
        self.on_recover = on_recover
        self.registry = registry
        self._clock = clock
        self._beats: dict = {}         # name -> last monotonic stamp
        self._lock = threading.Lock()
        self._stalled: set = set()     # guarded by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def enabled(self) -> bool:
        return self.stall_ms > 0

    def register(self, name: str) -> None:
        """Create the slot (counts as a fresh beat)."""
        self._beats[name] = self._clock()

    def beat(self, name: str) -> None:
        """Stamp one heartbeat — a single dict-slot float store."""
        self._beats[name] = self._clock()

    def ages_ms(self) -> dict:
        now = self._clock()
        return {n: (now - t) * 1e3 for n, t in self._beats.items()}

    def max_age_s(self) -> float:
        ages = self.ages_ms()
        return max(ages.values()) / 1e3 if ages else 0.0

    def stalled(self) -> list:
        """Names currently past the stall threshold (sorted)."""
        with self._lock:
            return sorted(self._stalled)

    # -- monitor thread -------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mri-obs-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def check(self) -> list:
        """One monitor pass (public for tests): fire newly stalled
        threads, clear recovered ones, return the stalled list."""
        if not self.enabled:
            return []
        fired, recovered = [], []
        ages = self.ages_ms()
        with self._lock:
            for name, age in ages.items():
                if age > self.stall_ms:
                    if name not in self._stalled:
                        self._stalled.add(name)
                        fired.append((name, age))
                elif name in self._stalled:
                    self._stalled.discard(name)
                    recovered.append(name)
            current = sorted(self._stalled)
        for name, age in fired:
            if self.registry is not None:
                self.registry.counter(STALLS_TOTAL).inc()
            if self.on_stall is not None:
                try:
                    self.on_stall(name, age)
                except Exception:  # noqa: BLE001 — detection must survive
                    pass
        for name in recovered:
            if self.on_recover is not None:
                try:
                    self.on_recover(name)
                except Exception:  # noqa: BLE001 — detection must survive
                    pass
        return current

    def _run(self) -> None:
        # 4 checks per stall threshold: detection lag stays well under
        # the 2x flip bound the healthz contract promises
        interval = max(0.01, min(1.0, self.stall_ms / 4e3))
        while not self._stop.wait(interval):
            self.check()
