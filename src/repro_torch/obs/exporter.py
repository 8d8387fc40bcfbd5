"""OpenMetrics/Prometheus text exposition for the metrics registry.

Copy of :mod:`repro.obs.exporter`, with the same ``repro_*``
metric names, so a scrape configuration does not change, and one
repair: the scrape endpoint counts a scrape before its body goes out,
so a client that has read it sees it counted.

The registry (:mod:`repro_torch.obs.metrics`) already holds everything a
serving engine measures; this module renders it in the one format
every scraper on earth understands — the `OpenMetrics text format
<https://prometheus.io/docs/specs/om/open_metrics_spec/>`_ — so a
live :class:`~repro_torch.runtime.engine.StreamEngine` can be watched by a
stock Prometheus without the repo growing a client dependency.

Three layers, each usable alone:

- **families** — :class:`MetricFamily` / :class:`Sample` are the
  typed intermediate: a family has a metric ``kind`` (``counter`` |
  ``gauge`` | ``summary``) and label-carrying samples.
  :func:`registry_families` lifts a
  :class:`~repro_torch.obs.metrics.MetricsRegistry` into families, with
  ``labels=`` stamped on every sample (the stable identity labels:
  ``app``, backend ``cache_key()``, device kind, ...) and ``rules=``
  mapping raw metric names into labelled families (the engine folds
  its ``phase_<p>_s`` histograms into ONE ``phase_seconds`` family
  with a ``phase`` label this way).
- **rendering** — :func:`render_openmetrics` produces the exposition
  text (``# TYPE`` lines, escaped label values, counters with the
  mandatory ``_total`` suffix, ``# EOF`` terminator);
  :func:`parse_openmetrics` is the matching strict reader used by
  tests and the CI gate — it validates metric-name / label-name
  grammar, escaping, type lines, and the EOF sentinel, so a format
  regression fails loudly instead of silently confusing a scraper.
- **serving** — :class:`MetricsHTTPServer` is an optional scrape
  endpoint on the stdlib ``http.server`` (a daemon thread; no new
  dependency), and :func:`write_openmetrics` /
  :func:`export_metrics_at_exit` cover headless runs that want the
  final exposition dropped to a file instead.

Values that are ``None`` or non-finite are **skipped at render time**
(OpenMetrics has no null): an empty reservoir exports its ``_count``
of 0 and no quantile samples, never a fake ``0.0`` percentile.
"""
from __future__ import annotations

import math
import os
import re
import tempfile
import threading
from typing import Any, Callable, Iterable, Mapping

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Sample", "MetricFamily", "registry_families",
           "render_openmetrics", "parse_openmetrics",
           "validate_openmetrics", "MetricsHTTPServer",
           "write_openmetrics", "export_metrics_at_exit",
           "flatten_report", "QUANTILES"]

#: quantiles exported for every reservoir histogram
QUANTILES = (0.5, 0.9, 0.99)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_KINDS = ("counter", "gauge", "summary")


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary registry name into a legal metric name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


def escape_label_value(v: Any) -> str:
    """Escape a label value per the exposition grammar."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Sample:
    """One exposition line: ``name{labels} value`` (+ optional suffix).

    ``suffix`` distinguishes the summary sub-series (``_count``,
    ``_sum``) and the counter ``_total``; plain gauges leave it empty.
    """

    __slots__ = ("labels", "value", "suffix")

    def __init__(self, value: float | int | None,
                 labels: Mapping[str, Any] | None = None,
                 suffix: str = ""):
        self.labels = dict(labels or {})
        self.value = value
        self.suffix = suffix


class MetricFamily:
    """A named metric of one ``kind`` with label-carrying samples.

    >>> fam = MetricFamily("served", "counter", "requests served")
    >>> fam.add(3, {"app": "blur"})
    >>> len(fam.samples)
    1
    """

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        self.name = sanitize_name(name)
        self.kind = kind
        self.help = help
        self.samples: list[Sample] = []

    def add(self, value: float | int | None,
            labels: Mapping[str, Any] | None = None,
            suffix: str = "") -> None:
        self.samples.append(Sample(value, labels, suffix))


def _histogram_samples(h: Histogram, labels: Mapping[str, Any],
                       extra: Mapping[str, Any] | None = None
                       ) -> list[Sample]:
    """Summary-family samples for one reservoir histogram.

    ``_count``/``_sum`` cover the whole observation stream; quantiles
    come from the (finite) reservoir and are omitted entirely when the
    reservoir holds no finite sample — never rendered as a fake 0.
    """
    base = dict(labels)
    if extra:
        base.update(extra)
    out = [Sample(h.count, base, "_count"), Sample(h.sum, base, "_sum")]
    xs = [x for x in h.samples() if math.isfinite(x)]
    if xs:
        xs.sort()
        for q in QUANTILES:
            idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
            out.append(Sample(xs[idx], dict(base, quantile=f"{q:g}")))
    return out


def registry_families(registry: MetricsRegistry, *,
                      labels: Mapping[str, Any] | None = None,
                      namespace: str = "repro",
                      rules: Mapping[str, tuple[str, Mapping[str, Any]]]
                      | None = None) -> dict[str, MetricFamily]:
    """Lift every metric of ``registry`` into exposition families.

    ``labels`` are stamped on every sample (identity labels: ``app``,
    backend ``cache_key()``, device kind...).  ``rules`` maps a raw
    registry metric name to ``(family_name, extra_labels)`` so several
    registry metrics can fold into one labelled family — e.g. every
    ``phase_<p>_s`` histogram into ``phase_seconds{phase="<p>"}``.
    Returns ``{family_name: MetricFamily}`` (insertion-ordered by
    sorted registry name).

    >>> reg = MetricsRegistry()
    >>> reg.counter("served").inc(2)
    >>> fams = registry_families(reg, labels={"app": "blur"})
    >>> fams["repro_served"].kind
    'counter'
    """
    base = dict(labels or {})
    rules = dict(rules or {})
    fams: dict[str, MetricFamily] = {}
    for name in registry.names():
        m = registry.get(name)
        if m is None:            # racing unregister; nothing to render
            continue
        fam_name, extra = rules.get(name, (name, {}))
        fam_name = sanitize_name(f"{namespace}_{fam_name}"
                                 if namespace else fam_name)
        if isinstance(m, Counter):
            fam = fams.setdefault(fam_name,
                                  MetricFamily(fam_name, "counter"))
            fam.add(m.value, dict(base, **extra), "_total")
        elif isinstance(m, Gauge):
            fam = fams.setdefault(fam_name, MetricFamily(fam_name, "gauge"))
            fam.add(m.value, dict(base, **extra))
        elif isinstance(m, Histogram):
            fam = fams.setdefault(fam_name,
                                  MetricFamily(fam_name, "summary"))
            fam.samples.extend(_histogram_samples(m, base, extra))
    return fams


def _render_value(v: float | int) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_openmetrics(families: Iterable[MetricFamily] |
                       Mapping[str, MetricFamily]) -> str:
    """Render families as OpenMetrics exposition text.

    Families render in the given order; samples whose value is
    ``None`` or non-finite are skipped (the format has no null — a
    missing series is the honest encoding of "no data").  The payload
    always ends with the ``# EOF`` sentinel scrapers use to detect
    truncated responses.
    """
    if isinstance(families, Mapping):
        families = families.values()
    lines: list[str] = []
    seen: set[str] = set()
    for fam in families:
        if fam.name in seen:
            raise ValueError(f"duplicate metric family {fam.name!r}")
        seen.add(fam.name)
        if fam.help:
            lines.append(f"# HELP {fam.name} "
                         + fam.help.replace("\\", "\\\\")
                         .replace("\n", "\\n"))
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            v = s.value
            if v is None or (isinstance(v, float) and not math.isfinite(v)):
                continue
            suffix = s.suffix
            if fam.kind == "counter" and suffix == "":
                suffix = "_total"
            label_str = ""
            if s.labels:
                inner = ",".join(
                    f'{sanitize_name(str(k))}="{escape_label_value(val)}"'
                    for k, val in sorted(s.labels.items()))
                label_str = "{" + inner + "}"
            lines.append(f"{fam.name}{suffix}{label_str} "
                         f"{_render_value(v)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# strict reader / validator (tests + CI gate)
# ----------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>[0-9.eE+-]+))?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SUFFIXES = ("_total", "_count", "_sum")


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_openmetrics(text: str) -> dict[str, dict[str, Any]]:
    """Parse (and strictly validate) an OpenMetrics exposition.

    Returns ``{family: {"type": kind, "samples": [(suffix, labels,
    value), ...]}}``.  Raises :class:`ValueError` on every grammar
    violation the renderer could regress into: a missing ``# EOF``,
    samples before their ``# TYPE`` line, malformed metric or label
    names, unparseable label blocks or values, counter samples without
    ``_total``.

    >>> fams = parse_openmetrics(render_openmetrics(
    ...     [MetricFamily("x", "gauge")]))
    >>> fams["x"]["type"]
    'gauge'
    """
    if not text.endswith("# EOF\n") and text.rstrip("\n") != "# EOF":
        raise ValueError("exposition does not end with '# EOF'")
    fams: dict[str, dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            raise ValueError(f"line {lineno}: blank line in exposition")
        if line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            try:
                _, _, name, kind = line.split(" ", 3)
            except ValueError:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            if kind not in _KINDS:
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            if not _NAME_RE.match(name):
                raise ValueError(f"line {lineno}: bad metric name {name!r}")
            if name in fams:
                raise ValueError(f"line {lineno}: duplicate family "
                                 f"{name!r}")
            fams[name] = {"type": kind, "samples": []}
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: unknown comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        raw = m.group("name")
        fam_name, suffix = raw, ""
        for suf in _SUFFIXES:
            if raw.endswith(suf) and raw[:-len(suf)] in fams:
                fam_name, suffix = raw[:-len(suf)], suf
                break
        if fam_name not in fams:
            raise ValueError(f"line {lineno}: sample {raw!r} precedes its "
                             f"TYPE line")
        fam = fams[fam_name]
        if fam["type"] == "counter" and suffix != "_total":
            raise ValueError(f"line {lineno}: counter sample {raw!r} "
                             f"missing _total suffix")
        labels: dict[str, str] = {}
        block = m.group("labels")
        if block:
            pos = 0
            while pos < len(block):
                pair = _LABEL_PAIR_RE.match(block, pos)
                if pair is None:
                    raise ValueError(f"line {lineno}: unparseable label "
                                     f"block {block!r} at offset {pos}")
                k, v = pair.group(1), _unescape(pair.group(2))
                if k in labels:
                    raise ValueError(f"line {lineno}: duplicate label "
                                     f"{k!r}")
                labels[k] = v
                pos = pair.end()
                if pos < len(block):
                    if block[pos] != ",":
                        raise ValueError(f"line {lineno}: expected ',' in "
                                         f"label block {block!r}")
                    pos += 1
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {lineno}: bad value "
                             f"{m.group('value')!r}")
        fam["samples"].append((suffix, labels, value))
    return fams


def validate_openmetrics(text: str) -> dict[str, int]:
    """Parse ``text`` strictly; return summary stats for assertions."""
    fams = parse_openmetrics(text)
    return {"families": len(fams),
            "samples": sum(len(f["samples"]) for f in fams.values()),
            "counters": sum(f["type"] == "counter" for f in fams.values()),
            "summaries": sum(f["type"] == "summary"
                             for f in fams.values())}


def flatten_report(d: Mapping[str, Any], *, sep: str = ".",
                   prefix: str = "") -> dict[str, Any]:
    """Flatten a nested report dict into one level of dotted keys.

    The headless-export companion to the exposition format: a nested
    ``Telemetry.report()`` becomes a flat scalar dict that lands in
    JSON/CSV without structure-aware consumers.

    >>> flatten_report({"a": {"b": 1}, "c": 2})
    {'a.b': 1, 'c': 2}
    """
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_report(v, sep=sep, prefix=key))
        else:
            out[key] = v
    return out


# ----------------------------------------------------------------------
# serving the exposition
# ----------------------------------------------------------------------

#: scrape responses carry the version the format mandates
CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


class MetricsHTTPServer:
    """A stdlib scrape endpoint: ``GET /metrics`` renders live text.

    No dependency beyond ``http.server``; the server thread is a
    daemon, so a crashed engine never hangs on its exporter.  Pass
    ``port=0`` to bind an ephemeral port (tests, multi-engine hosts)
    and read it back from :attr:`port` / :attr:`url`.

    ``render`` is any zero-arg callable returning exposition text —
    typically ``engine.openmetrics`` — and is called per scrape, so
    scrapers always see current values.
    """

    def __init__(self, render: Callable[[], str], *,
                 host: str = "127.0.0.1", port: int = 0):
        import http.server

        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:      # noqa: N802 (stdlib casing)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    payload = outer.render().encode("utf-8")
                except Exception as e:      # render must not kill serving
                    self.send_error(500, explain=str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                # counted before the body goes out: a client that has
                # read its scrape sees it counted
                with outer._count_lock:
                    outer.scrapes += 1
                self.wfile.write(payload)

            def log_message(self, *args: Any) -> None:
                pass                        # scrapes are not stderr news

        self.render = render
        self.scrapes = 0
        self._count_lock = threading.Lock()
        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       _Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-exporter",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def write_openmetrics(path: str, text_or_render: str | Callable[[], str]
                      ) -> str:
    """Atomically write an exposition to ``path``; returns the path."""
    text = (text_or_render() if callable(text_or_render)
            else text_or_render)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def export_metrics_at_exit(path: str, render: Callable[[], str]) -> None:
    """Register an atexit hook dumping the final exposition to ``path``.

    The headless-run answer to a scrape endpoint: a batch job or CI
    step gets its last metric state on disk without running a server.
    Failures are swallowed — an exporter must never turn a clean exit
    into a traceback.
    """
    import atexit

    def _dump() -> None:
        try:
            write_openmetrics(path, render)
        except Exception:
            pass

    atexit.register(_dump)
