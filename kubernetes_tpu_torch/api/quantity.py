"""resource.Quantity: exact fixed-point resource arithmetic.

Reimplements the semantics of apimachinery's resource.Quantity
(reference: staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go)
that the scheduler depends on:

  - parse decimal SI ("100m", "2", "1.5", "2k", "3M"), binary SI
    ("1Ki", "2Gi"), and scientific notation ("12e6")
  - Value()      -> int64, ceil to integer   (quantity.go Value/ScaledValue(0))
  - MilliValue() -> int64, ceil(q * 1000)    (quantity.go MilliValue)

All scheduler math downstream is int64 milli-units (CPU) or bytes (memory),
mirroring framework.Resource (reference: pkg/scheduler/framework/types.go:318).
Exactness matters: binding-decision parity with the reference requires the
same integer values, so parsing uses rational arithmetic, never floats.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from functools import lru_cache
from typing import Union

# Binary SI suffixes (quantity.go `BinarySI` format)
_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
# Decimal SI suffixes (`DecimalSI`)
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])|[eE](?P<exp>[+-]?\d+))?$"
)


def parse_quantity(s: Union[str, int, float, "Quantity"]) -> Fraction:
    """Parse a quantity string to an exact Fraction."""
    if isinstance(s, Quantity):
        return s.rational
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        return Fraction(str(s))
    return _parse_quantity_str(s)


@lru_cache(maxsize=8192)
def _parse_quantity_str(s: str) -> Fraction:
    # Fractions are immutable, so the cached value is safe to share.
    # Workloads repeat a handful of request strings ("100m", "128Mi", ...)
    # across every pod; the uncached Fraction math showed up in scheduler
    # hot-loop profiles (NodeInfo.add_pod -> calculate_resource).
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    value = Fraction(m.group("num"))
    if m.group("sign") == "-":
        value = -value
    suffix = m.group("suffix")
    exp = m.group("exp")
    if suffix in _BINARY_SUFFIXES:
        value *= _BINARY_SUFFIXES[suffix]
    elif suffix is not None:
        value *= _DECIMAL_SUFFIXES[suffix]
    elif exp is not None:
        value *= Fraction(10) ** int(exp)
    return value


def _ceil_int64(x: Fraction) -> int:
    """Round toward +inf to an integer (quantity.go roundUp semantics)."""
    return math.ceil(x)


class Quantity:
    """Immutable exact quantity. Hashable, comparable by value."""

    __slots__ = ("rational",)

    def __init__(self, value: Union[str, int, float, Fraction, "Quantity"]):
        if isinstance(value, Fraction):
            self.rational = value
        else:
            self.rational = parse_quantity(value)

    def value(self) -> int:
        """Integer value, rounded up (quantity.go Value)."""
        return _ceil_int64(self.rational)

    def milli_value(self) -> int:
        """Value * 1000 rounded up (quantity.go MilliValue)."""
        return _ceil_int64(self.rational * 1000)

    def scaled_value(self, scale: int) -> int:
        """Value / 10**scale, rounded up (quantity.go ScaledValue)."""
        return _ceil_int64(self.rational / Fraction(10) ** scale)

    def is_zero(self) -> bool:
        return self.rational == 0

    def __eq__(self, other) -> bool:
        if isinstance(other, Quantity):
            return self.rational == other.rational
        return NotImplemented

    def __lt__(self, other: "Quantity") -> bool:
        return self.rational < other.rational

    def __le__(self, other: "Quantity") -> bool:
        return self.rational <= other.rational

    def __hash__(self) -> int:
        return hash(self.rational)

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"

    def __str__(self) -> str:
        r = self.rational
        if r.denominator == 1:
            return str(r.numerator)
        milli = r * 1000
        if milli.denominator == 1:
            return f"{milli.numerator}m"
        return f"{float(r):g}"


@lru_cache(maxsize=8192)
def milli_value_of(q: Union[str, int, float, "Quantity"]) -> int:
    """MilliValue of a quantity literal, memoized by the literal.

    The string parse is already cached (_parse_quantity_str), but the
    Fraction multiply + ceil per MilliValue call was not — and it
    dominated calculate_resource in the completion worker's assume
    profile (workloads repeat a handful of request literals across
    every pod). Hashable literals only, which is what serde yields.
    """
    return _ceil_int64(parse_quantity(q) * 1000)


@lru_cache(maxsize=8192)
def value_of(q: Union[str, int, float, "Quantity"]) -> int:
    """Value (ceil to integer) of a quantity literal, memoized."""
    return _ceil_int64(parse_quantity(q))


def cpu_milli(requests: dict, key: str = "cpu") -> int:
    """CPU request in milli-cores from a resource map of quantity strings."""
    q = requests.get(key)
    return milli_value_of(q) if q is not None else 0


def mem_bytes(requests: dict, key: str = "memory") -> int:
    q = requests.get(key)
    return value_of(q) if q is not None else 0
