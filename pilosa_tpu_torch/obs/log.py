"""Trace-correlated structured logging.

One logging setup for the whole process (`setup()`, driven by the
[log] config section) and one way to get a logger (`get_logger`), so
the scattered inline `logging.basicConfig` / `logging.getLogger`
fallbacks converge on a single pipeline. Every record — text or JSON —
carries the active trace/span id from the contextvar CURRENT, which
obs/trace.py's spans set.

`get_logger("mesh")` returns the stdlib logger "pilosa_tpu_torch.mesh":
library code keeps working under plain `logging.basicConfig` (tests,
embedding apps) and only `setup()` opts a process into the structured
pipeline. setup() is idempotent and reconfigures on repeated calls —
the last [log] section wins, and handlers never stack.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from typing import Optional

from contextvars import ContextVar

ROOT = "pilosa_tpu_torch"

# The active span (obs/trace.Span), read by TraceContextFilter: a
# record written inside a query carries its trace and span ids.
CURRENT: ContextVar = ContextVar("pilosa_tpu_torch_span", default=None)

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


class TraceContextFilter(logging.Filter):
    """Stamp the active trace/span onto every record (None when no
    trace is live — one ContextVar read, same cost rule as span())."""

    def filter(self, record: logging.LogRecord) -> bool:
        sp = CURRENT.get()
        if sp is not None:
            record.trace_id = sp.trace.trace_id
            record.span_id = sp.span_id
            record.span = sp.name
        else:
            record.trace_id = None
            record.span_id = None
            record.span = None
        return True


class JSONFormatter(logging.Formatter):
    """One JSON object per line: machine-shippable, trace-joinable."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "component": record.name,
            "msg": record.getMessage(),
        }
        if getattr(record, "trace_id", None):
            out["trace_id"] = record.trace_id
            out["span_id"] = record.span_id
            out["span"] = record.span
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"), default=str)


class TextFormatter(logging.Formatter):
    """Human format; the trace id rides in brackets when present so
    grep still finds it."""

    def __init__(self):
        super().__init__("%(asctime)s %(levelname)s %(name)s %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        tid = getattr(record, "trace_id", None)
        if tid:
            line += f" [trace={tid}:{record.span_id}]"
        return line


_mu = threading.Lock()
_handler: Optional[logging.Handler] = None


def setup(level: str = "info", fmt: str = "text",
          path: str = "") -> logging.Logger:
    """Configure the pilosa_tpu_torch logger tree from the [log] config
    section. Returns the root "pilosa_tpu_torch" logger (handy as the
    HTTP server's access logger)."""
    global _handler
    root = logging.getLogger(ROOT)
    with _mu:
        if _handler is not None:
            root.removeHandler(_handler)
            _handler.close()
        if path:
            handler: logging.Handler = logging.FileHandler(path)
        else:
            handler = logging.StreamHandler(sys.stderr)
        handler.addFilter(TraceContextFilter())
        handler.setFormatter(JSONFormatter() if fmt == "json"
                             else TextFormatter())
        root.addHandler(handler)
        root.setLevel(_LEVELS.get((level or "info").lower(), logging.INFO))
        # The tree terminates here: records must not ALSO flow into a
        # basicConfig'd stdlib root and print twice.
        root.propagate = False
        _handler = handler
    return root


def get_logger(component: str) -> logging.Logger:
    """The one way library code names its logger: get_logger("mesh")
    -> logging.getLogger("pilosa_tpu_torch.mesh"). Accepts already-qualified
    names so call sites can migrate mechanically."""
    name = component if component.startswith(ROOT) \
        else f"{ROOT}.{component}" if component else ROOT
    return logging.getLogger(name)
