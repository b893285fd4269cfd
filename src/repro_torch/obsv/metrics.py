"""Counters, gauges, exponential-bucket histograms + Prometheus rendering
(the port's copy of ``repro.obsv.metrics``; the metric names, the
exposition text and the checker are the reference's, so a scraper reads
either package's service alike).

A ``MetricsRegistry`` is a flat namespace of named instruments, each keyed
by an optional label set (``counter.inc(1, status="completed")``).  The
service layer owns one registry per ``GraphQueryService`` and renders it in
Prometheus *exposition format* (``render_prometheus``) for scraping;
``parse_prometheus`` is the matching in-repo format checker the CI smoke
step and the bench canary run against the rendered text, so a malformed
exposition line fails the build instead of the scrape.

Histograms use exponential buckets (``start · factor^i``): latency spans
4–5 decades between a cache-hit tick and a cold chunk fetch, so uniform
buckets would waste resolution where p99s live.  Rendered histograms are
cumulative (each ``le`` bucket counts *all* observations ≤ bound, ``+Inf``
equals ``_count``), exactly per the Prometheus contract.
"""

from __future__ import annotations

import re
from bisect import bisect_left

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# one exposition sample: name{labels} value   (labels optional)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: tuple, extra: list[tuple[str, str]] = ()) -> str:
    pairs = list(extra) + list(key)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class Counter:
    """Monotonically increasing value per label set."""

    kind = "counter"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def snapshot(self) -> dict:
        return {key: v for key, v in self._values.items()}

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, v in sorted(self._values.items()) or [((), 0)]:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines


class Gauge:
    """Point-in-time value per label set (may go up or down)."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def snapshot(self) -> dict:
        return {key: v for key, v in self._values.items()}

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._values.items()) or [((), 0)]:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines


class Histogram:
    """Exponential-bucket histogram (``start · factor^i`` upper bounds)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str, *, start: float = 1e-4,
                 factor: float = 4.0, count: int = 12):
        if start <= 0 or factor <= 1 or count < 1:
            raise ValueError("need start > 0, factor > 1, count >= 1")
        self.name = name
        self.help = help_text
        self.bounds = [start * factor ** i for i in range(count)]
        # per label set: ([per-bucket counts..., overflow], sum, count)
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        rec = self._series.get(key)
        if rec is None:
            rec = self._series[key] = [[0] * (len(self.bounds) + 1), 0.0, 0]
        rec[0][bisect_left(self.bounds, value)] += 1
        rec[1] += value
        rec[2] += 1

    def count(self, **labels) -> int:
        rec = self._series.get(_label_key(labels))
        return rec[2] if rec else 0

    def sum(self, **labels) -> float:
        rec = self._series.get(_label_key(labels))
        return rec[1] if rec else 0.0

    def snapshot(self) -> dict:
        out = {}
        for key, (buckets, total, n) in self._series.items():
            cum, acc = [], 0
            for b in buckets:
                acc += b
                cum.append(acc)
            out[key] = {
                "bounds": list(self.bounds) + [float("inf")],
                "cumulative": cum,
                "sum": total,
                "count": n,
            }
        return out

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        series = self._series or {(): [[0] * (len(self.bounds) + 1), 0.0, 0]}
        for key, (buckets, total, n) in sorted(series.items()):
            acc = 0
            for bound, b in zip(self.bounds + [float("inf")], buckets):
                acc += b
                lab = _render_labels(key, extra=[("le", _fmt(bound))])
                lines.append(f"{self.name}_bucket{lab} {acc}")
            lines.append(f"{self.name}_sum{_render_labels(key)} {_fmt(total)}")
            lines.append(f"{self.name}_count{_render_labels(key)} {n}")
        return lines


class MetricsRegistry:
    """Get-or-create namespace of instruments; one per service/process."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help_text: str, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help_text, **kwargs)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
            )
        return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "", *,
                  start: float = 1e-4, factor: float = 4.0,
                  count: int = 12) -> Histogram:
        return self._get(Histogram, name, help_text,
                         start=start, factor=factor, count=count)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict dump: {name: {"type", "help", "series"}}."""
        return {
            name: {"type": m.kind, "help": m.help, "series": m.snapshot()}
            for name, m in sorted(self._metrics.items())
        }

    def render_prometheus(self) -> str:
        lines: list[str] = []
        for _name, m in sorted(self._metrics.items()):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Exposition-format checker (consumed by CI smoke + the bench canary).
# ---------------------------------------------------------------------------


def parse_prometheus(text: str) -> dict:
    """Parse + validate Prometheus exposition text; raises ``ValueError``.

    Checks, beyond line syntax: every sample belongs to a ``# TYPE``-declared
    family; histogram families expose ``_bucket``/``_sum``/``_count`` with a
    ``+Inf`` bucket per label set, cumulative bucket counts monotone in
    ``le``, and ``+Inf == _count``.  Returns
    ``{family: {"type", "help", "samples": [(name, labels, value), ...]}}``.
    """
    families: dict[str, dict] = {}
    declared: dict[str, str] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {ln}: malformed HELP: {raw!r}")
            fam = families.setdefault(
                parts[2], {"type": None, "help": "", "samples": []}
            )
            fam["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if (len(parts) != 4 or not _NAME_RE.match(parts[2])
                    or parts[3] not in ("counter", "gauge", "histogram",
                                        "summary", "untyped")):
                raise ValueError(f"line {ln}: malformed TYPE: {raw!r}")
            declared[parts[2]] = parts[3]
            fam = families.setdefault(
                parts[2], {"type": None, "help": "", "samples": []}
            )
            fam["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {raw!r}")
        name = m.group("name")
        labels: dict[str, str] = {}
        if m.group("labels"):
            body = m.group("labels")
            for pm in _LABEL_PAIR_RE.finditer(body):
                if not _LABEL_RE.match(pm.group(1)):
                    raise ValueError(
                        f"line {ln}: bad label name {pm.group(1)!r}"
                    )
                labels[pm.group(1)] = pm.group(2)
            leftovers = _LABEL_PAIR_RE.sub("", body).strip(", \t")
            if leftovers:
                raise ValueError(
                    f"line {ln}: malformed labels {body!r}"
                )
        val_s = m.group("value")
        if val_s == "+Inf":
            value = float("inf")
        elif val_s == "-Inf":
            value = float("-inf")
        else:
            try:
                value = float(val_s)
            except ValueError:
                raise ValueError(
                    f"line {ln}: non-numeric value {val_s!r}"
                ) from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stripped = name[: -len(suffix)] if name.endswith(suffix) else None
            if stripped and declared.get(stripped) == "histogram":
                base = stripped
                break
        if base not in declared:
            raise ValueError(
                f"line {ln}: sample {name!r} has no # TYPE declaration"
            )
        families[base]["samples"].append((name, labels, value))

    for fam_name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        # group by label set minus 'le'
        by_series: dict[tuple, dict] = {}
        for name, labels, value in fam["samples"]:
            key = _label_key({k: v for k, v in labels.items() if k != "le"})
            s = by_series.setdefault(
                key, {"buckets": [], "sum": None, "count": None}
            )
            if name == fam_name + "_bucket":
                if "le" not in labels:
                    raise ValueError(
                        f"{fam_name}: bucket sample missing le label"
                    )
                le = (float("inf") if labels["le"] == "+Inf"
                      else float(labels["le"]))
                s["buckets"].append((le, value))
            elif name == fam_name + "_sum":
                s["sum"] = value
            elif name == fam_name + "_count":
                s["count"] = value
        for key, s in by_series.items():
            buckets = sorted(s["buckets"])
            if not buckets or buckets[-1][0] != float("inf"):
                raise ValueError(f"{fam_name}{dict(key)}: no +Inf bucket")
            counts = [c for _, c in buckets]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(
                    f"{fam_name}{dict(key)}: bucket counts not cumulative"
                )
            if s["count"] is None or s["sum"] is None:
                raise ValueError(
                    f"{fam_name}{dict(key)}: missing _sum/_count"
                )
            if counts[-1] != s["count"]:
                raise ValueError(
                    f"{fam_name}{dict(key)}: +Inf bucket {counts[-1]} "
                    f"!= _count {s['count']}"
                )
    return families
