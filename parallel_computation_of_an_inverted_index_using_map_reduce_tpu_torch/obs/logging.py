"""Unified structured logging for the mri_torch runtime (the JAX
package's ``obs/logging.py`` on this package's own logger tree).

Every runtime event the serve/obs layer reports — slow queries, stall
detections, reload outcomes — funnels through :func:`emit`: one JSON
payload per record (``{"event": ..., **fields}``), rate-limited per
``(logger, event)`` key so a pathological burst (every request slow,
a flapping watchdog) cannot flood stderr or the test log.  The record
*message* is always the compact JSON payload, so ``caplog``-style
consumers parse it identically in both output formats.

:func:`configure` (the serve daemon calls it at startup) attaches one
stderr handler to the ``mri_torch`` logger tree and picks the rendering
from ``MRI_OBS_LOG_FORMAT``:

* ``text`` — classic ``LEVEL logger: message`` lines, and
* ``json`` — one self-describing JSON object per line (``ts``,
  ``level``, ``logger`` + the payload fields), ready for ingestion.

Dropped records are counted in ``mri_obs_log_dropped_total`` on the
process-global default registry — silence is never silent.

Stdlib-only by design (plus the sibling stdlib-only modules): import
must never pull torch or numpy.  The tree is this package's own, so
configuring it never reroutes the JAX package's ``mri_tpu.*`` loggers
in the same process.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from ..utils import envknobs
from . import metrics as obs_metrics

FORMAT_ENV = "MRI_OBS_LOG_FORMAT"
RATE_LIMIT_ENV = "MRI_OBS_LOG_RATE_LIMIT"

#: root of the runtime logger tree configure() attaches to
ROOT_LOGGER = "mri_torch"

_HANDLER_TAG = "_mri_obs_handler"


def log_format() -> str:
    return envknobs.get(FORMAT_ENV)


def rate_limit() -> int:
    return envknobs.get(RATE_LIMIT_ENV)


class _RateLimiter:
    """Token bucket per key: ``limit`` records per rolling second."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._state: dict = {}  # guarded by: self._lock

    def allow(self, key) -> bool:
        if self.limit <= 0:
            return True
        now = time.monotonic()
        with self._lock:
            sec, n = self._state.get(key, (0, 0))
            cur = int(now)
            if cur != sec:
                sec, n = cur, 0
            if n >= self.limit:
                self._state[key] = (sec, n)
                return False
            self._state[key] = (sec, n + 1)
            return True


_limiter: _RateLimiter | None = None
_limiter_lock = threading.Lock()


def _get_limiter() -> _RateLimiter:
    global _limiter
    with _limiter_lock:
        if _limiter is None or _limiter.limit != rate_limit():
            _limiter = _RateLimiter(rate_limit())
        return _limiter


def emit(logger: logging.Logger, event: str,
         level: int = logging.INFO, **fields) -> None:
    """The one funnel for runtime events: rate-limited, JSON payload.

    Never raises — a logging failure must not take a serving thread
    down with it.
    """
    try:
        if not _get_limiter().allow((logger.name, event)):
            obs_metrics.default_registry().counter(
                "mri_obs_log_dropped_total").inc()
            return
        payload = {"event": event, **fields}
        logger.log(level, "%s",
                   json.dumps(payload, separators=(",", ":"),
                              default=str))
    except Exception:  # noqa: BLE001 — logging must never crash serving
        pass


class JsonFormatter(logging.Formatter):
    """One JSON object per line: envelope + the record's payload.

    A message that is itself a JSON object (everything :func:`emit`
    produces) is merged into the envelope; anything else lands under
    ``msg`` so third-party records still serialize cleanly.
    """

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
        }
        msg = record.getMessage()
        try:
            payload = json.loads(msg)
        except ValueError:
            payload = None
        if isinstance(payload, dict):
            for k, v in payload.items():
                out.setdefault(k, v)
        else:
            out["msg"] = msg
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"), default=str)


def configure(stream=None) -> logging.Handler:
    """Attach (or re-format) the single mri_torch stderr handler.

    Idempotent: repeated calls swap the formatter in place instead of
    stacking handlers, so a test can flip ``MRI_OBS_LOG_FORMAT`` and
    reconfigure.  Returns the handler for tests.
    """
    root = logging.getLogger(ROOT_LOGGER)
    handler = None
    for h in root.handlers:
        if getattr(h, _HANDLER_TAG, False):
            handler = h
            break
    if handler is None:
        handler = logging.StreamHandler(stream)
        setattr(handler, _HANDLER_TAG, True)
        root.addHandler(handler)
        root.propagate = False
    elif stream is not None:
        handler.setStream(stream)
    if log_format() == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    if root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    return handler


def reset() -> None:
    """Detach the configure() handler (tests)."""
    root = logging.getLogger(ROOT_LOGGER)
    for h in list(root.handlers):
        if getattr(h, _HANDLER_TAG, False):
            root.removeHandler(h)
    root.propagate = True
