"""OpenMetrics text exposition — the fleet's standard scrape surface.

Renders ``MetricsRegistry.snapshot()`` dicts (and their
``aggregate.merge`` folds) in the Prometheus / OpenMetrics text
format, so the manager's ``/metrics`` endpoint and ``kb-stats
--openmetrics`` plug straight into the existing monitoring ecosystem
(Prometheus scrape -> Grafana) without a sidecar exporter.

Type mapping from the registry's four series kinds:

  * counters   -> ``counter``  (sample name gains the ``_total``
                  suffix the spec requires; a raw name already ending
                  in ``_total`` keeps it as the suffix)
  * gauges     -> ``gauge``
  * EMA rates  -> ``gauge``    (``<name>_rate``: a decayed
                  events/second is a last-value sample, not a
                  monotone total)
  * histograms -> ``histogram`` (cumulative ``_bucket{le=...}``
                  series over the registry's static log2 edges,
                  plus ``_count`` / ``_sum``)
  * derived    -> ``gauge``    (``execs_per_sec`` & co)

Metric/label names are sanitized to the spec's charset (anything
else becomes ``_``); label values are escaped (``\\``, ``\"``,
newline).  The exposition always ends with ``# EOF``.  Conformance is
pinned by the strict pure-python parser in the test suite
(tests/openmetrics_parser.py), which CI runs against a live manager
scrape.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from .metrics import HIST_BUCKETS

#: exposition content type (the version Prometheus negotiates)
CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")

#: default metric namespace
PREFIX = "kbz"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary registry series name into the spec's
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` charset (collisions after
    sanitization merge into one family — acceptable for telemetry)."""
    name = _NAME_BAD.sub("_", str(name)) or "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label_name(name: str) -> str:
    name = _LABEL_BAD.sub("_", str(name)) or "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    """Sample value formatting: integral floats print as integers
    (smaller exposition, same parse), everything else as repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Family:
    """One metric family: a name, a type, and labeled samples."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str,
                 help_text: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        #: [(sample name, label pairs, value)]
        self.samples: List[Tuple[str, Tuple[Tuple[str, str], ...],
                                 float]] = []


def new_families() -> "Dict[str, Family]":
    return {}


def _family(fams: Dict[str, Family], name: str, kind: str,
            help_text: Optional[str] = None) -> Optional[Family]:
    """Get-or-create; a name already claimed by a DIFFERENT type
    keeps its first type (the sample is dropped rather than emitting
    a malformed exposition)."""
    fam = fams.get(name)
    if fam is None:
        fam = fams[name] = Family(name, kind, help_text)
    return fam if fam.kind == kind else None


def _labels(labels: Optional[Dict[str, str]]
            ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple((sanitize_label_name(k), str(v))
                 for k, v in labels.items())


def add_counter(fams: Dict[str, Family], name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                help_text: Optional[str] = None) -> None:
    if name.endswith("_total"):
        name = name[:-len("_total")]
    fam = _family(fams, name, "counter", help_text)
    if fam is not None and math.isfinite(float(value)):
        fam.samples.append((name + "_total", _labels(labels),
                            max(0.0, float(value))))


def add_gauge(fams: Dict[str, Family], name: str, value: float,
              labels: Optional[Dict[str, str]] = None,
              help_text: Optional[str] = None) -> None:
    fam = _family(fams, name, "gauge", help_text)
    if fam is not None and math.isfinite(float(value)):
        fam.samples.append((name, _labels(labels), float(value)))


def add_histogram(fams: Dict[str, Family], name: str,
                  hist: Dict[str, Any],
                  labels: Optional[Dict[str, str]] = None,
                  help_text: Optional[str] = None) -> None:
    """One registry histogram (per-bucket ``counts`` over the static
    HIST_BUCKETS edges) as a cumulative OpenMetrics histogram; counts
    beyond the known edges fold into ``+Inf``."""
    fam = _family(fams, name, "histogram", help_text)
    if fam is None:
        return
    counts = [int(c) for c in hist.get("counts", [])]
    lab = _labels(labels)
    cum = 0
    for i, edge in enumerate(HIST_BUCKETS):
        if i < len(counts):
            cum += counts[i]
        fam.samples.append((name + "_bucket",
                            lab + (("le", repr(float(edge))),), cum))
    cum += sum(counts[len(HIST_BUCKETS):])
    fam.samples.append((name + "_bucket", lab + (("le", "+Inf"),),
                        cum))
    fam.samples.append((name + "_count", lab, cum))
    fam.samples.append((name + "_sum", lab,
                        max(0.0, float(hist.get("sum", 0.0)))))


def add_snapshot(fams: Dict[str, Family], snap: Dict[str, Any],
                 labels: Optional[Dict[str, str]] = None,
                 prefix: str = PREFIX,
                 include_hists: bool = True) -> None:
    """Fold one registry snapshot into the family set under
    ``labels`` — called once per worker (labels ``{campaign,
    worker}``) and once per fleet fold (labels ``{campaign}``, with
    ``prefix="kbz_fleet"`` so per-worker and fleet-total families
    never mix in one sum())."""
    for k, v in (snap.get("counters") or {}).items():
        add_counter(fams, f"{prefix}_{sanitize_metric_name(k)}", v,
                    labels)
    for k, v in (snap.get("gauges") or {}).items():
        add_gauge(fams, f"{prefix}_{sanitize_metric_name(k)}", v,
                  labels)
    for k, r in (snap.get("rates") or {}).items():
        add_gauge(fams,
                  f"{prefix}_{sanitize_metric_name(k)}_rate",
                  (r or {}).get("rate", 0.0), labels,
                  help_text="EMA events/second")
    for k, v in (snap.get("derived") or {}).items():
        add_gauge(fams, f"{prefix}_{sanitize_metric_name(k)}", v,
                  labels)
    if include_hists:
        # "_duration_seconds", not "_seconds": the registry already
        # pairs every histogram with a "<name>_seconds" total counter
        # and the two must land in distinct families
        for k, h in (snap.get("hists") or {}).items():
            add_histogram(
                fams,
                f"{prefix}_{sanitize_metric_name(k)}"
                "_duration_seconds",
                h or {}, labels, help_text="stage latency seconds")


def render_families(fams: Dict[str, Family]) -> str:
    """The exposition: families sorted by name, ``# TYPE`` (and
    optional ``# HELP``) before their samples, ``# EOF`` last."""
    out: List[str] = []
    for name in sorted(fams):
        fam = fams[name]
        if not fam.samples:
            continue
        if fam.help:
            out.append(f"# HELP {name} {fam.help}")
        out.append(f"# TYPE {name} {fam.kind}")
        seen = set()
        for sample_name, labels, value in fam.samples:
            key = (sample_name, labels)
            if key in seen:          # spec: no duplicate name+labels
                continue
            seen.add(key)
            if labels:
                body = ",".join(
                    f'{k}="{escape_label_value(v)}"'
                    for k, v in labels)
                out.append(f"{sample_name}{{{body}}} "
                           f"{_fmt_value(value)}")
            else:
                out.append(f"{sample_name} {_fmt_value(value)}")
    out.append("# EOF")
    return "\n".join(out) + "\n"


def render_snapshot(snap: Dict[str, Any],
                    labels: Optional[Dict[str, str]] = None,
                    prefix: str = PREFIX) -> str:
    """One snapshot as a full exposition (``kb-stats
    --openmetrics``)."""
    fams = new_families()
    add_snapshot(fams, snap, labels, prefix=prefix)
    return render_families(fams)
