# Port copy of kubetpu/bridge/quantity.py, verbatim apart from this note (no JAX in it).
"""Kubernetes resource.Quantity parsing — canonical int conversion.

Covers the quantity grammar the scheduler actually meets in Pod/Node specs
(reference: staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go):

    <quantity>  ::= <signedNumber><suffix>
    <suffix>    ::= <binarySI> | <decimalSI> | <decimalExponent>
    binarySI    ::= Ki | Mi | Gi | Ti | Pi | Ei
    decimalSI   ::= m | "" | k | M | G | T | P | E
    decimalExp  ::= e<signedInt> | E<signedInt>

Exact integer math (fractions) — no float rounding on resource bookkeeping.
Canonical units match ``kubetpu.api.types``: cpu in millicores, everything
else in base units (bytes for memory/storage) rounded UP like the
reference's ``Value()``/``MilliValue()`` ceil semantics.
"""

from __future__ import annotations

from fractions import Fraction

_BINARY = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL = {
    "m": Fraction(1, 1000),
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(s: str | int | float) -> Fraction:
    """Quantity string → exact Fraction in base units."""
    if isinstance(s, (int, float)):
        return Fraction(s).limit_denominator(10**9)
    s = s.strip()
    if not s:
        raise ValueError("empty quantity")
    # decimal exponent form: 129e6 / 12E3
    for marker in ("e", "E"):
        if marker in s and not s.endswith(("Ei", "E")):
            num, _, exp = s.partition(marker)
            return Fraction(num) * Fraction(10) ** int(exp)
    for suf, mult in _BINARY.items():
        if s.endswith(suf):
            return Fraction(s[: -len(suf)]) * mult
    # longest decimal suffixes are single chars; "" handled last
    if s and s[-1] in _DECIMAL and not s[-1].isdigit():
        return Fraction(s[:-1]) * _DECIMAL[s[-1]]
    return Fraction(s)


def _ceil(f: Fraction) -> int:
    return -((-f.numerator) // f.denominator)


def quantity_to_int(s: str | int | float) -> int:
    """Value(): base units, rounded up (quantity.go Value)."""
    return _ceil(parse_quantity(s))


def quantity_to_milli(s: str | int | float) -> int:
    """MilliValue(): thousandths, rounded up (quantity.go MilliValue)."""
    return _ceil(parse_quantity(s) * 1000)


def canonical_resource(name: str, s: str | int | float) -> int:
    """Resource quantity → the framework's canonical int unit
    (NodeInfo.Resource semantics, pkg/scheduler/framework/types.go Resource:
    cpu→MilliValue, everything else→Value)."""
    if name == "cpu":
        return quantity_to_milli(s)
    return quantity_to_int(s)
