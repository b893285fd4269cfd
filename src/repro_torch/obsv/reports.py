"""Typed telemetry reports (the port's copy of the reference's
``PlanReport``/``EnumReport``/``EnumLevel``/``OocReport``/``BatchReport``/
``ServiceReport`` schema).

Each report is a ``Mapping``, so ``report["device_rounds"]`` and
``dict(report)`` behave as the plain dicts the searchers fill; ``from_dict``
checks the exact key set and ``validate`` the value types.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass, field

SCHEMA_VERSION = 1


def _plain(v):
    """Recursively convert a report/np-scalar tree to plain Python."""
    if isinstance(v, Report):
        return v.to_dict()
    if isinstance(v, Mapping):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        t = type(v) if type(v) in (list, tuple) else list
        return t(_plain(x) for x in v)
    if hasattr(v, "item") and getattr(v, "shape", None) == ():
        return v.item()  # numpy or torch scalar
    return v


_SCALAR_CHECKS = {
    "int": lambda x: isinstance(x, int) and not isinstance(x, bool),
    "float": lambda x: isinstance(x, (int, float)) and not isinstance(x, bool),
    "bool": lambda x: isinstance(x, bool),
    "str": lambda x: isinstance(x, str),
    "str | None": lambda x: x is None or isinstance(x, str),
    "int | None": lambda x: x is None or isinstance(x, int),
}


class Report(Mapping):
    """Mapping-compatible dataclass base for the reports below."""

    SCHEMA_VERSION = SCHEMA_VERSION

    def __getitem__(self, key):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __iter__(self):
        return (f.name for f in dataclasses.fields(self))

    def __len__(self):
        return len(dataclasses.fields(self))

    def to_dict(self) -> dict:
        return {f.name: _plain(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def __eq__(self, other):
        if isinstance(other, Mapping):
            return self.to_dict() == _plain(other)
        return NotImplemented

    __hash__ = None  # mutable mapping semantics

    @classmethod
    def from_dict(cls, d: Mapping) -> "Report":
        """Build from a mapping with exactly this report's keys; raises on a
        missing or unknown key, then validates the values."""
        names = {f.name for f in dataclasses.fields(cls)}
        defaulted = {
            f.name for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING
            or f.default_factory is not dataclasses.MISSING
        }
        got = set(d.keys())
        missing = names - got - defaulted
        unknown = got - names
        if missing or unknown:
            raise ValueError(
                f"{cls.__name__}: schema v{cls.SCHEMA_VERSION} mismatch — "
                f"missing keys {sorted(missing)}, unknown keys "
                f"{sorted(unknown)}"
            )
        obj = cls(**{k: d[k] for k in got})
        obj.validate()
        return obj

    def validate(self) -> "Report":
        """Type-check every field against its annotation; returns self."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            checker = getattr(self, f"_check_{f.name}", None)
            if checker is not None:
                checker(v)
                continue
            ann = f.type if isinstance(f.type, str) else f.type.__name__
            ok = _SCALAR_CHECKS.get(ann)
            if ok is not None and not ok(v):
                raise ValueError(
                    f"{type(self).__name__}.{f.name}: expected {ann}, "
                    f"got {type(v).__name__} ({v!r})"
                )
        return self

    def __post_init__(self):
        # normalize numpy/torch scalars so getattr/json never leak them
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if hasattr(v, "item") and getattr(v, "shape", None) == ():
                object.__setattr__(self, f.name, v.item())


@dataclass(eq=False)
class PlanReport(Report):
    """``stats.extras["plan"]`` — the planner's decision for one query."""

    order: tuple
    source: str
    est_cost: float
    fingerprint: object
    plan_seconds: float

    def _check_order(self, v):
        if not isinstance(v, tuple):
            raise ValueError(f"PlanReport.order: expected tuple, got "
                             f"{type(v).__name__}")

    def _check_fingerprint(self, v):
        pass  # opaque planner token (hex digest, or None when skipped)

    def __post_init__(self):
        object.__setattr__(self, "order", tuple(self.order))
        super().__post_init__()

    @classmethod
    def skipped(cls) -> "PlanReport":
        """The filter-killed contract: planner present, nothing to order."""
        return cls(order=(), source="skipped", est_cost=0.0,
                   fingerprint=None, plan_seconds=0.0)


@dataclass(eq=False)
class EnumLevel(Report):
    """One per-level record of ``EnumReport.levels``."""

    level: int
    emit_rows: list
    rebalanced: bool
    rebalance_seconds: float

    def _check_emit_rows(self, v):
        if not isinstance(v, list) or not all(isinstance(x, int) for x in v):
            raise ValueError(f"EnumLevel.emit_rows: expected list[int], got {v!r}")

    def __post_init__(self):
        object.__setattr__(self, "emit_rows", [int(x) for x in self.emit_rows])
        super().__post_init__()


@dataclass(eq=False)
class EnumReport(Report):
    """``stats.extras["enum"]`` — two-phase device-join telemetry (field
    meanings at ``core.search.empty_enum_report``)."""

    device_rounds: int
    host_levels: int
    count_seconds: float
    scan_seconds: float
    emit_seconds: float
    max_table_rows: int
    max_emit_rows: int
    scan_path: "str | None"
    enum_shards: int
    emit_rows_max: int
    emit_rows_min: int
    rebalance_rounds: int
    rebalance_rows_moved: int
    rebalance_seconds: float
    levels: list = field(default_factory=list)

    def _check_levels(self, v):
        if not isinstance(v, list):
            raise ValueError("EnumReport.levels: expected list")
        for lvl in v:
            if not isinstance(lvl, EnumLevel):
                raise ValueError(
                    "EnumReport.levels: expected EnumLevel entries, got "
                    f"{type(lvl).__name__}"
                )
            lvl.validate()

    def _check_scan_path(self, v):
        if v is not None and v not in ("device", "host"):
            raise ValueError(
                f"EnumReport.scan_path: expected 'device'/'host'/None, got {v!r}"
            )

    def __post_init__(self):
        object.__setattr__(self, "levels", [
            lvl if isinstance(lvl, EnumLevel) else EnumLevel.from_dict(lvl)
            for lvl in self.levels
        ])
        super().__post_init__()

    @classmethod
    def empty(cls) -> "EnumReport":
        return cls(
            device_rounds=0, host_levels=0,
            count_seconds=0.0, scan_seconds=0.0, emit_seconds=0.0,
            max_table_rows=0, max_emit_rows=0,
            scan_path=None, enum_shards=0,
            emit_rows_max=0, emit_rows_min=0,
            rebalance_rounds=0, rebalance_rows_moved=0,
            rebalance_seconds=0.0, levels=[],
        )


@dataclass(eq=False)
class OocReport(Report):
    """``stats.extras["ooc"]`` — chunk-IO telemetry of one fetch, or of an
    epoch's fetches summed by the service.

    ``fetches`` counts the ``fetch_restricted`` calls in the report.
    ``n_chunks``, ``peak_resident_bytes``, ``resident_budget_bytes`` and
    ``partial`` are point-in-time gauges; the other fields sum.
    ``partial=True`` marks a report from the ``ChunkIOError`` path: its
    counters cover the work done before the fault.
    """

    chunks_read: int
    cache_hits: int
    cache_misses: int
    bytes_read: int
    n_chunks: int
    edges_fetched: int
    peak_resident_bytes: int
    resident_budget_bytes: int
    fetch_seconds: float
    fetches: int = 1
    partial: bool = False

    GAUGES = ("n_chunks", "peak_resident_bytes", "resident_budget_bytes",
              "partial")

    def merge(self, other: Mapping) -> "OocReport":
        """This report with another fetch's added in."""
        d = self.to_dict()
        for k, v in other.items():
            if k in self.GAUGES:
                d[k] = bool(d[k] or v) if k == "partial" else v
            else:
                d[k] = d.get(k, 0) + v
        return OocReport.from_dict(d)


@dataclass(eq=False)
class BatchReport(Report):
    """``stats.extras["batch"]`` — shape-bucket placement of one query."""

    bucket: tuple
    batch_size: int

    def _check_bucket(self, v):
        if not (isinstance(v, tuple) and len(v) == 3):
            raise ValueError(
                f"BatchReport.bucket: expected (d_max, l_pad, u_pad), "
                f"got {v!r}"
            )

    def __post_init__(self):
        object.__setattr__(
            self, "bucket", tuple(int(x) for x in self.bucket)
        )
        super().__post_init__()


@dataclass(eq=False)
class ServiceReport(Report):
    """``stats.extras["service"]`` — scheduling facts for one request of
    the graph-query service.  ``deadline_missed`` records a request that
    completed after its deadline (a request still queued at its deadline
    expires instead)."""

    slot: int
    epoch: int
    queue_seconds: float
    rounds: int = 0
    trace_id: int | None = None
    tenant: str = "default"
    priority: int = 0
    deadline_missed: bool = False


REPORT_TYPES: dict[str, type] = {
    "plan": PlanReport,
    "enum": EnumReport,
    "ooc": OocReport,
    "batch": BatchReport,
    "service": ServiceReport,
}


def validate_extras(extras: Mapping) -> None:
    """Raise unless every known ``stats.extras`` key carries its typed,
    valid report; unknown keys (scalars such as
    ``store_prefilter_alive``) pass through."""
    for key, cls in REPORT_TYPES.items():
        if key in extras:
            rep = extras[key]
            if not isinstance(rep, cls):
                raise ValueError(
                    f"extras[{key!r}]: expected {cls.__name__}, got "
                    f"{type(rep).__name__}"
                )
            rep.validate()
