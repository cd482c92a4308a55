"""Named metrics: labeled counters / gauges / histograms + time series.

One registry per serve session: every observation is a named instrument
with optional labels, readable three ways —

* :meth:`MetricsRegistry.snapshot` — one JSON-safe dict (what
  ``ServerMetrics.report()`` builds its view from);
* :meth:`MetricsRegistry.exposition` — Prometheus-style text, so a
  deployment can expose the session state on a ``/metrics``-shaped
  endpoint without new plumbing;
* ring-buffer :class:`TimeSeries` for controller trajectories (p95
  wait, active rung, backlog estimate) — bounded memory, newest-N
  retained, the thing a dashboard plots.

Samples are validated at the door: a NaN/inf observation raises
immediately (with the instrument name) instead of silently poisoning a
percentile later — the serving layer's distributions all come through
here.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


def _require_finite(value: float, where: str) -> float:
    v = float(value)
    if not math.isfinite(v):
        raise ValueError(f"{where}: non-finite sample {value!r} — metrics "
                         "reject NaN/inf at observation time")
    return v


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class TimeSeries:
    """Bounded ``(t, value)`` ring buffer (newest ``capacity`` points)."""

    def __init__(self, name: str, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self._buf: Deque[Tuple[float, float]] = deque(maxlen=self.capacity)

    def record(self, t: float, value: float) -> None:
        self._buf.append((_require_finite(t, f"series {self.name!r} time"),
                          _require_finite(value, f"series {self.name!r}")))

    def items(self) -> List[Tuple[float, float]]:
        return list(self._buf)

    def last(self) -> Optional[Tuple[float, float]]:
        return self._buf[-1] if self._buf else None

    def __len__(self) -> int:
        return len(self._buf)


class MetricsRegistry:
    """Counters, gauges, histograms (raw samples), and time series."""

    def __init__(self):
        self._counters: Dict[str, Dict[tuple, float]] = {}
        self._gauges: Dict[str, Dict[tuple, float]] = {}
        self._hists: Dict[str, Dict[tuple, List[float]]] = {}
        self._series: Dict[str, TimeSeries] = {}

    # -- writes --------------------------------------------------------------

    def inc(self, name: str, n: float = 1, **labels) -> None:
        _require_finite(n, f"counter {name!r}")
        key = _label_key(labels)
        slot = self._counters.setdefault(name, {})
        slot[key] = slot.get(key, 0) + n

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges.setdefault(name, {})[_label_key(labels)] = \
            _require_finite(value, f"gauge {name!r}")

    def observe(self, name: str, value: float, **labels) -> None:
        self._hists.setdefault(name, {}).setdefault(
            _label_key(labels), []).append(
                _require_finite(value, f"histogram {name!r}"))

    def series(self, name: str, capacity: int = 256) -> TimeSeries:
        """Get-or-create the named time series (capacity applies on
        creation only)."""
        if name not in self._series:
            self._series[name] = TimeSeries(name, capacity)
        return self._series[name]

    # -- reads ---------------------------------------------------------------

    def counter(self, name: str, **labels) -> float:
        return self._counters.get(name, {}).get(_label_key(labels), 0)

    def counter_total(self, name: str) -> float:
        return sum(self._counters.get(name, {}).values())

    def labeled(self, name: str, label: str) -> Dict[str, float]:
        """A single-label counter as ``{label_value: total}`` — the shape
        ``ServerMetrics``' dict attributes have."""
        out: Dict[str, float] = {}
        for key, v in self._counters.get(name, {}).items():
            d = dict(key)
            if label in d:
                out[d[label]] = out.get(d[label], 0) + v
        return out

    def gauge(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(name, {}).get(_label_key(labels))

    def samples(self, name: str, **labels) -> List[float]:
        if labels:
            return list(self._hists.get(name, {}).get(_label_key(labels),
                                                      []))
        out: List[float] = []
        for xs in self._hists.get(name, {}).values():
            out.extend(xs)
        return out

    def names(self) -> Dict[str, List[str]]:
        return {"counters": sorted(self._counters),
                "gauges": sorted(self._gauges),
                "histograms": sorted(self._hists),
                "series": sorted(self._series)}

    # -- export --------------------------------------------------------------

    @staticmethod
    def _labels_str(key: tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in key)
        return "{" + inner + "}"

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-safe dict of everything: counters/gauges keyed by
        ``name{label="v"}``, histograms summarized, series as point
        lists."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}, "series": {}}
        for name, slots in sorted(self._counters.items()):
            for key, v in sorted(slots.items()):
                out["counters"][name + self._labels_str(key)] = v
        for name, slots in sorted(self._gauges.items()):
            for key, v in sorted(slots.items()):
                out["gauges"][name + self._labels_str(key)] = v
        for name, slots in sorted(self._hists.items()):
            for key, xs in sorted(slots.items()):
                s = sorted(xs)
                out["histograms"][name + self._labels_str(key)] = {
                    "n": len(s), "sum": sum(s),
                    "min": s[0] if s else None,
                    "max": s[-1] if s else None,
                }
        for name, ts in sorted(self._series.items()):
            out["series"][name] = [[t, v] for t, v in ts.items()]
        return out

    def exposition(self) -> str:
        """Prometheus-style text: ``# TYPE`` lines, then one sample line
        per (name, label set).  Histograms expose ``_count``/``_sum``;
        series expose their latest value as a gauge."""
        lines: List[str] = []
        for name, slots in sorted(self._counters.items()):
            lines.append(f"# TYPE {name} counter")
            for key, v in sorted(slots.items()):
                lines.append(f"{name}{self._labels_str(key)} {v:g}")
        for name, slots in sorted(self._gauges.items()):
            lines.append(f"# TYPE {name} gauge")
            for key, v in sorted(slots.items()):
                lines.append(f"{name}{self._labels_str(key)} {v:g}")
        for name, slots in sorted(self._hists.items()):
            lines.append(f"# TYPE {name} summary")
            for key, xs in sorted(slots.items()):
                ls = self._labels_str(key)
                lines.append(f"{name}_count{ls} {len(xs)}")
                lines.append(f"{name}_sum{ls} {sum(xs):g}")
        for name, ts in sorted(self._series.items()):
            last = ts.last()
            if last is not None:
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {last[1]:g}")
        return "\n".join(lines) + "\n"
