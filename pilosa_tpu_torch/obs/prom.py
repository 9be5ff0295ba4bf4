"""Prometheus text exposition (format version 0.0.4).

A small metrics registry — Counter/Gauge/Histogram families with real
label pairs — plus the renderer that turns families into the scrape
text. Two usage modes, both served from ONE registry at /metrics:

  - direct instruments: ``reg.counter("pilosa_x_total", "...").labels(
    mode="fused").inc()`` for code that wants first-class metrics;
  - collect-time collectors: ``reg.register_collector(fn)`` where `fn`
    returns MetricFamily objects built at scrape time from existing
    stat stores (ExpvarStats, StatMap, cache stat dicts). Collectors
    keep the hot write paths untouched — the scrape pays the bridge
    cost, not every query.

The log₂ Histogram (obs.metrics) maps onto cumulative `le` buckets
exactly: its bucket b holds values in [2^(b-1), 2^b) (bucket 0 holds
[0, 1)), so the cumulative count at ``le = 2^b`` is the prefix sum of
buckets 0..b. Buckets are emitted up to the highest occupied slot plus
``+Inf``; `_sum`/`_count` come from the histogram's own accumulators,
so they are exact even though bucket boundaries are log-spaced.

Stdlib-only and lock-cheap, like the rest of obs/: rendering takes
each store's lock only long enough to snapshot it.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .metrics import Histogram

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_SUB = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SUB = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_name(name: str) -> str:
    """Squash an arbitrary stat key ("query.us", "index:i,query") into
    a legal metric name. Idempotent on already-legal names."""
    if _NAME_OK.match(name):
        return name
    out = _NAME_SUB.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def sanitize_label(name: str) -> str:
    out = _LABEL_SUB.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(v: str) -> str:
    """Backslash, double-quote, and newline escaping per the text
    format spec — the three characters that would corrupt a sample
    line."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(v: str) -> str:
    """HELP lines escape backslash and newline only (quotes are
    legal there)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v) -> str:
    """Canonical sample value: integers render without a trailing .0
    (scrapers accept either; the short form diffs cleanly in tests)."""
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def format_labels(labels: Iterable[Tuple[str, str]]) -> str:
    pairs = [f'{sanitize_label(k)}="{escape_label_value(v)}"'
             for k, v in labels]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricFamily:
    """One family: name + type + help + samples. Samples carry an
    optional name suffix so histogram expansions (`_bucket`, `_sum`,
    `_count`) stay inside their family block, as the format requires.

    A sample may additionally carry an exemplar — (trace_id, value,
    wall ts) — as a fourth tuple slot; exemplars are only emitted when
    rendering with ``exemplars=True`` (OpenMetrics syntax), so default
    scrapes stay plain text-format 0.0.4."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help_text: str = ""):
        self.name = sanitize_name(name)
        self.mtype = mtype  # "counter" | "gauge" | "histogram" | "untyped"
        self.help = help_text
        # (suffix, ((label, value), ...), numeric[, exemplar])
        self.samples: List[tuple] = []

    def add(self, value, labels: Optional[dict] = None,
            suffix: str = "") -> "MetricFamily":
        self.samples.append(
            (suffix, tuple((labels or {}).items()), value))
        return self

    def add_histogram(self, hist: Histogram,
                      labels: Optional[dict] = None) -> "MetricFamily":
        """Expand one log₂ Histogram into cumulative `le` buckets plus
        `_sum`/`_count` under the given labels. Bucket exemplars (when
        the histogram holds any) ride along on their bucket's line."""
        counts, total, total_sum = hist.bucket_snapshot()
        exemplars = hist.exemplar_snapshot()
        base = tuple((labels or {}).items())
        top = 0
        for b, n in enumerate(counts):
            if n:
                top = b
        cum = 0
        for b in range(top + 1):
            cum += counts[b]
            key = ("_bucket", base + (("le", format_value(1 << b)),), cum)
            ex = exemplars.get(b)
            self.samples.append(key + (ex,) if ex is not None else key)
        self.samples.append(("_bucket", base + (("le", "+Inf"),), total))
        self.samples.append(("_sum", base, total_sum))
        self.samples.append(("_count", base, total))
        return self

    def render(self, exemplars: bool = False) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.mtype}")
        for sample in self.samples:
            suffix, labels, value = sample[:3]
            line = (f"{self.name}{suffix}{format_labels(labels)} "
                    f"{format_value(value)}")
            if exemplars and len(sample) > 3 and sample[3] is not None:
                tid, ev, ets = sample[3]
                line += (f' # {{trace_id="{escape_label_value(tid)}"}} '
                         f"{format_value(ev)} {ets:.3f}")
            lines.append(line)
        return "\n".join(lines)


def render(families: Iterable[MetricFamily],
           exemplars: bool = False) -> str:
    """Full exposition text. Trailing newline per the spec; families
    render in the order given (stable output diffs cleanly)."""
    return "\n".join(f.render(exemplars=exemplars)
                     for f in families if f.samples) + "\n"


class _Series:
    """One labeled time series inside an instrument."""

    __slots__ = ("_inst", "_key")

    def __init__(self, inst: "_Instrument", key: tuple):
        self._inst = inst
        self._key = key

    def inc(self, delta=1):
        inst = self._inst
        with inst._mu:
            inst._series[self._key] = inst._series.get(self._key, 0) + delta

    def set(self, value):
        inst = self._inst
        with inst._mu:
            inst._series[self._key] = value

    def observe(self, value, exemplar=None):
        inst = self._inst
        with inst._mu:
            h = inst._series.get(self._key)
            if h is None:
                h = inst._series[self._key] = Histogram()
        h.observe(value, exemplar=exemplar)


class _Instrument:
    """A registered family: counter, gauge, or histogram. Series are
    keyed by the sorted label tuple; `labels()` with no arguments is
    the unlabeled series."""

    def __init__(self, name: str, kind: str, help_text: str = ""):
        self.name = sanitize_name(name)
        self.kind = kind
        self.help = help_text
        self._mu = threading.Lock()
        self._series: Dict[tuple, object] = {}

    def labels(self, **kv) -> _Series:
        return _Series(self, tuple(sorted(kv.items())))

    # Unlabeled conveniences.
    def inc(self, delta=1):
        self.labels().inc(delta)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value, exemplar=None):
        self.labels().observe(value, exemplar=exemplar)

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.kind, self.help)
        with self._mu:
            series = list(self._series.items())
        for key, v in series:
            labels = dict(key)
            if self.kind == "histogram":
                fam.add_histogram(v, labels)
            else:
                fam.add(v, labels)
        return fam


class Registry:
    """Instrument + collector registry behind /metrics. One per
    process is typical (the handler owns it); collectors run at scrape
    time and may raise — a failing collector is skipped, never fails
    the scrape."""

    def __init__(self):
        self._mu = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[[], Iterable[MetricFamily]]] = []

    def _instrument(self, name: str, kind: str, help_text: str) -> _Instrument:
        with self._mu:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _Instrument(
                    name, kind, help_text)
            elif inst.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help_text: str = "") -> _Instrument:
        return self._instrument(name, "counter", help_text)

    def gauge(self, name: str, help_text: str = "") -> _Instrument:
        return self._instrument(name, "gauge", help_text)

    def histogram(self, name: str, help_text: str = "") -> _Instrument:
        return self._instrument(name, "histogram", help_text)

    def register_collector(self, fn: Callable[[], Iterable[MetricFamily]]):
        with self._mu:
            self._collectors.append(fn)

    def collect(self) -> List[MetricFamily]:
        with self._mu:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        fams = [inst.collect() for inst in instruments]
        for fn in collectors:
            try:
                fams.extend(fn())
            except Exception:  # noqa: BLE001 — one bad bridge ≠ no scrape
                continue
        return fams

    def render(self, exemplars: bool = False) -> str:
        return render(self.collect(), exemplars=exemplars)


def _tag_labels(tags: Iterable[str]) -> dict:
    """Stat tags ("index:i") → label pairs; a bare tag becomes
    tag="...". Later duplicate keys win, matching with_tags layering."""
    out = {}
    for t in tags:
        k, sep, v = str(t).partition(":")
        if sep:
            out[sanitize_label(k)] = v
        else:
            out["tag"] = t
    return out


def expvar_families(stats, prefix: str = "pilosa_") -> List[MetricFamily]:
    """Bridge an ExpvarStats store into families at scrape time: every
    existing count/gauge/timing call-site exports for free. Counters
    get the `_total` suffix; tags become labels; histograms expand
    into cumulative buckets. Series sharing a name but differing in
    tags merge into one family."""
    structured = getattr(stats, "structured", None)
    if structured is None:
        return []
    values, sets, hists, kinds = structured()

    help_text = ("Auto-exported from an ExpvarStats call site "
                 "(also at /debug/vars).")
    fams: Dict[str, MetricFamily] = {}
    for (name, tags), v in sorted(values.items()):
        kind = kinds.get(name, "gauge")
        mname = prefix + sanitize_name(name)
        if kind == "counter" and not mname.endswith("_total"):
            mname += "_total"
        fam = fams.get(mname)
        if fam is None:
            fam = fams[mname] = MetricFamily(mname, kind, help_text)
        fam.add(v, _tag_labels(tags))
    for (name, tags), h in sorted(hists.items()):
        mname = prefix + sanitize_name(name)
        fam = fams.get(mname)
        if fam is None:
            fam = fams[mname] = MetricFamily(mname, "histogram",
                                             help_text)
        fam.add_histogram(h, _tag_labels(tags))
    # String sets export as info-style gauges: value 1, the string a
    # label — the only faithful mapping onto a numeric format.
    for (name, tags), s in sorted(sets.items()):
        mname = prefix + sanitize_name(name) + "_info"
        fam = fams.get(mname)
        if fam is None:
            fam = fams[mname] = MetricFamily(mname, "gauge", help_text)
        labels = _tag_labels(tags)
        labels["value"] = s
        fam.add(1, labels)
    return list(fams.values())


def statmap_families(stats: dict, prefix: str,
                     help_text: str = "") -> List[MetricFamily]:
    """Bridge a StatMap (or plain stats dict) into one gauge family
    per key. StatMaps mix counters and gauges; untyped-as-gauge keeps
    every scraper happy without guessing."""
    copy = stats.copy() if hasattr(stats, "copy") else dict(stats)
    if not help_text:
        help_text = (f"Auto-exported stat key from the "
                     f"{prefix.rstrip('_')} store.")
    fams = []
    for k, v in sorted(copy.items()):
        if not isinstance(v, (int, float)):
            continue
        fams.append(MetricFamily(prefix + sanitize_name(str(k)),
                                 "gauge", help_text).add(v))
    return fams
