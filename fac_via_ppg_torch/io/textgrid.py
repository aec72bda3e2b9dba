"""Minimal Praat TextGrid object model, with its own Praat serialization
(the port's copy of fac_via_ppg_tpu/io/textgrid.py).

The reference depends on the external `textgrid` package (reference
src/common/utterance.py:28, align.py:18) for four classes and a handful of
methods.  That package is not in this image, so this module provides a
compatible implementation of exactly the surface the pipeline uses:
Interval/IntervalTier (add, addInterval, indexContaining, _fillInTheGaps,
intervals, minTime/maxTime/name), Point/PointTier, and TextGrid (append,
getFirst, tiers, iteration, len).

Serialization lives on the objects themselves (`TextGrid.to_praat` /
`TextGrid.from_praat`) rather than in free functions like the reference's
align.py:23-195.  The parser is deliberately format-agnostic: Praat's long
("ooTextFile") and short formats carry the identical *value stream* — the
same quoted strings and numbers in the same order — and differ only in
decoration (`key = ` prefixes, `item [n]:` headers, the `tiers? <exists>`
flag).  So instead of branching per format line-by-line, `_PraatScanner`
extracts the value stream and one structural parse handles both.
"""

from __future__ import annotations

from typing import List, Optional


class Interval:
    def __init__(self, minTime: float, maxTime: float, mark: str = ""):
        if minTime >= maxTime:
            raise ValueError(
                f"Interval requires minTime < maxTime ({minTime} >= {maxTime})"
            )
        self.minTime = minTime
        self.maxTime = maxTime
        self.mark = mark

    def __eq__(self, other):
        return (
            isinstance(other, Interval)
            and self.minTime == other.minTime
            and self.maxTime == other.maxTime
            and self.mark == other.mark
        )

    def overlaps(self, other: "Interval") -> bool:
        return (
            other.minTime < self.maxTime and self.minTime < other.maxTime
        )

    def __repr__(self):
        return f"Interval({self.minTime}, {self.maxTime}, {self.mark!r})"


class Point:
    def __init__(self, time: float, mark: str = ""):
        self.time = time
        self.mark = mark

    def __repr__(self):
        return f"Point({self.time}, {self.mark!r})"


class IntervalTier:
    def __init__(self, name: str = "", minTime: float = 0.0,
                 maxTime: Optional[float] = None):
        self.name = name
        self.minTime = minTime
        self.maxTime = maxTime
        self.intervals: List[Interval] = []
        self.strict = True

    def add(self, minTime: float, maxTime: float, mark: str = ""):
        self.addInterval(Interval(minTime, maxTime, mark))

    def addInterval(self, interval: Interval):
        for existing in self.intervals:
            if self.strict and interval.overlaps(existing):
                raise ValueError(
                    f"{interval} overlaps {existing} in tier {self.name!r}"
                )
        self.intervals.append(interval)
        self.intervals.sort(key=lambda iv: iv.minTime)
        if self.maxTime is not None and interval.maxTime > self.maxTime:
            self.maxTime = interval.maxTime

    def _fillInTheGaps(self, null: str = "") -> List[Interval]:
        """Return intervals with explicit null-marked gap intervals, as the
        Praat writer needs (used by align write, reference align.py:52)."""
        out: List[Interval] = []
        prev_end = self.minTime
        for iv in self.intervals:
            if iv.minTime > prev_end:
                out.append(Interval(prev_end, iv.minTime, null))
            out.append(iv)
            prev_end = iv.maxTime
        if self.maxTime is not None and prev_end < self.maxTime:
            out.append(Interval(prev_end, self.maxTime, null))
        return out

    def indexContaining(self, time: float) -> Optional[int]:
        for i, iv in enumerate(self.intervals):
            if iv.minTime <= time < iv.maxTime:
                return i
        return None

    def _emit_praat(self, emit, grid_xmax: float, null: str):
        emit.field(2, "class", _quoted("IntervalTier"))
        emit.field(2, "name", _quoted(self.name))
        emit.field(2, "xmin", _num(self.minTime))
        emit.field(2, "xmax", _num(grid_xmax))
        dense = self._fillInTheGaps(null)
        emit.field(2, "intervals: size", len(dense))
        for j, iv in enumerate(dense, 1):
            emit.row(3, f"intervals [{j}]:")
            emit.field(4, "xmin", _num(iv.minTime))
            emit.field(4, "xmax", _num(iv.maxTime))
            emit.field(4, "text", _quoted(iv.mark))

    def __len__(self):
        return len(self.intervals)

    def __iter__(self):
        return iter(self.intervals)

    def __getitem__(self, i):
        return self.intervals[i]

    def __repr__(self):
        return f"IntervalTier({self.name!r}, n={len(self.intervals)})"


class PointTier:
    def __init__(self, name: str = "", minTime: float = 0.0,
                 maxTime: Optional[float] = None):
        self.name = name
        self.minTime = minTime
        self.maxTime = maxTime
        self.points: List[Point] = []

    def add(self, time: float, mark: str = ""):
        self.addPoint(Point(time, mark))

    def addPoint(self, point: Point):
        self.points.append(point)
        self.points.sort(key=lambda p: p.time)
        if self.maxTime is not None and point.time > self.maxTime:
            self.maxTime = point.time

    def _emit_praat(self, emit, grid_xmax: float, null: str):
        emit.field(2, "class", _quoted("TextTier"))
        emit.field(2, "name", _quoted(self.name))
        emit.field(2, "xmin", _num(self.minTime))
        emit.field(2, "xmax", _num(grid_xmax))
        emit.field(2, "points: size", len(self.points))
        for j, pt in enumerate(self.points, 1):
            emit.row(3, f"points [{j}]:")
            emit.field(4, "time", _num(pt.time))
            emit.field(4, "mark", _quoted(pt.mark))

    def __len__(self):
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __getitem__(self, i):
        return self.points[i]


class TextGrid:
    def __init__(self, name: str = "", minTime: float = 0.0,
                 maxTime: Optional[float] = None):
        self.name = name
        self.minTime = minTime
        self.maxTime = maxTime
        self.tiers: List = []
        self.strict = True

    def append(self, tier):
        self.tiers.append(tier)
        if self.maxTime is None or (
            tier.maxTime is not None and tier.maxTime > (self.maxTime or 0)
        ):
            self.maxTime = tier.maxTime

    def getFirst(self, tier_name: str):
        for tier in self.tiers:
            if tier.name == tier_name:
                return tier
        return None

    def getList(self, tier_name: str):
        return [t for t in self.tiers if t.name == tier_name]

    def getNames(self):
        return [t.name for t in self.tiers]

    def __len__(self):
        return len(self.tiers)

    def __iter__(self):
        return iter(self.tiers)

    def __getitem__(self, i):
        return self.tiers[i]

    def _end_time(self) -> float:
        if self.maxTime:
            return self.maxTime
        return max(
            t.maxTime if t.maxTime else t[-1].maxTime for t in self.tiers
        )

    def to_praat(self, null: str = "") -> str:
        """Serialize as a Praat long-format ("ooTextFile") document.

        Interval tiers are densified first: gaps between annotated
        intervals become explicit `null`-marked intervals, as Praat
        requires contiguous coverage.  Marks get Praat's doubled-quote
        escaping.
        """
        end = self._end_time()
        emit = _PraatEmitter()
        emit.field(0, "File type", _quoted("ooTextFile"))
        emit.field(0, "Object class", _quoted("TextGrid"))
        emit.row(0, "")
        emit.field(0, "xmin", _num(self.minTime))
        emit.field(0, "xmax", _num(end))
        emit.row(0, "tiers? <exists>")
        emit.field(0, "size", len(self.tiers))
        emit.row(0, "item []:")
        for i, tier in enumerate(self.tiers, 1):
            emit.row(1, f"item [{i}]:")
            tier._emit_praat(emit, end, null)
        return emit.render()

    @classmethod
    def from_praat(cls, text: str, round_digits: int = 5) -> "TextGrid":
        """Parse a Praat TextGrid document (long or short format).

        Times are rounded to `round_digits`; degenerate intervals
        (xmin >= xmax, e.g. Praat's zero-width placeholders) are dropped.
        """
        scan = _PraatScanner(text, round_digits)
        header = scan.string()
        if not header.startswith("ooTextFile"):
            raise ValueError(
                f"not a Praat text document (File type {header!r})"
            )
        object_class = scan.string()
        if object_class != "TextGrid":
            raise ValueError(
                f"Praat document holds a {object_class!r}, not a TextGrid"
            )
        tg = cls()
        tg.minTime = scan.number()
        tg.maxTime = scan.number()
        for _ in range(scan.count("tier count")):
            tier_class = scan.string()
            name = scan.string()
            tmin = scan.number()
            tmax = scan.number()
            count = scan.count(f"size of tier {name!r}")
            if tier_class == "IntervalTier":
                tier = IntervalTier(name, tmin, tmax)
                tier.strict = tg.strict
                for _ in range(count):
                    lo, hi = scan.number(), scan.number()
                    mark = scan.string()
                    if lo < hi:
                        tier.addInterval(Interval(lo, hi, mark))
            elif tier_class in ("TextTier", "PointTier"):
                tier = PointTier(name)
                for _ in range(count):
                    when = scan.number()
                    tier.addPoint(Point(when, scan.string()))
            else:
                raise ValueError(f"unknown tier class {tier_class!r}")
            tg.append(tier)
        return tg


# ---------------------------------------------------------------------------
# Praat text-format plumbing
# ---------------------------------------------------------------------------

def _quoted(mark: str) -> str:
    """Praat escapes an embedded double quote by doubling it."""
    return '"{}"'.format(str(mark).replace('"', '""'))


def _num(x) -> str:
    """Shortest exact decimal for a time value; ints stay ints."""
    f = float(x)
    return str(int(f)) if f.is_integer() else repr(f)


class _PraatEmitter:
    """Accumulates indented rows of a long-format Praat document."""

    INDENT = "    "

    def __init__(self):
        self._rows: List[str] = []

    def row(self, depth: int, content: str):
        self._rows.append(self.INDENT * depth + content if content else "")

    def field(self, depth: int, key: str, value):
        self.row(depth, f"{key} = {value}")

    def render(self) -> str:
        return "\n".join(self._rows) + "\n"


class _PraatScanner:
    """Yields the value stream of a Praat document, ignoring decoration.

    A line contributes a value if it has a `key = value` shape (long
    format) or is itself a bare quoted string / number (short format).
    Everything else — `item [n]:` headers, `tiers? <exists>`, blank lines —
    is layout.  Quoted values may span lines: Praat keeps literal newlines
    inside marks, so the scanner consumes lines until the quotes balance
    (escaped `""` pairs never unbalance them).
    """

    def __init__(self, text: str, round_digits: int):
        self._lines = text.splitlines()
        self._at = 0
        self._round = round_digits

    def _next_value(self) -> str:
        while self._at < len(self._lines):
            raw = self._lines[self._at]
            stripped = raw.strip()
            self._at += 1
            if not stripped:
                continue
            if stripped.startswith('"'):
                # slice from the raw line so whitespace INSIDE a quoted
                # value that spans lines survives verbatim
                payload = raw[raw.index('"'):]
            elif "=" in stripped:
                payload = raw.partition("=")[2].lstrip()
            else:
                payload = stripped
            if payload.startswith('"'):
                while payload.count('"') % 2:
                    if self._at >= len(self._lines):
                        raise ValueError(
                            f"unterminated quoted value: {payload[:40]!r}"
                        )
                    payload += "\n" + self._lines[self._at]
                    self._at += 1
                return payload
            payload = payload.strip()
            try:
                float(payload)
            except ValueError:
                continue  # decoration line
            return payload
        raise ValueError("Praat document ended mid-structure")

    def string(self) -> str:
        payload = self._next_value()
        if not payload.startswith('"'):
            raise ValueError(f"expected a quoted value, got {payload!r}")
        end = payload.rindex('"')  # ignore whitespace after the close quote
        return payload[1:end].replace('""', '"')

    def number(self) -> float:
        payload = self._next_value()
        if payload.startswith('"'):
            raise ValueError(f"expected a number, got {payload!r}")
        return round(float(payload), self._round)

    def count(self, what: str) -> int:
        """A size field: a corrupt negative value must raise, not silently
        parse zero items (range() of a negative is empty), and a
        huge/inf value must raise ValueError, not OverflowError."""
        n = self.number()
        if not 0 <= n <= 10**7:
            raise ValueError(f"implausible {what} {n} in Praat document")
        return int(n)
