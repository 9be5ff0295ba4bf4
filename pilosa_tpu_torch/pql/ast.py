"""PQL AST. Argument values carry the parser's Python types: int,
float, bool, None, str, list, and Cond for a field comparison.
`Call.__str__` serializes a call so that it parses back to itself."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Comparison operators a Cond may carry, in canonical spelling.
COND_OPS = (">", ">=", "<", "<=", "==", "!=", "><")


@dataclass(frozen=True)
class Cond:
    """A value comparison attached to an argument key: the parse of
    `field >= 10` in Range(frame=f, field >= 10). `value` is an int, or a
    (low, high) tuple for `><` (between, inclusive)."""

    op: str
    value: Any

    def __post_init__(self):
        if self.op not in COND_OPS:
            raise ValueError(f"invalid condition operator {self.op!r}")
        if isinstance(self.value, list):
            object.__setattr__(self, "value", tuple(self.value))

    def __str__(self) -> str:
        return f"{self.op} {_fmt_value(self.value)}"


def _fmt_value(v: Any) -> str:
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, float):
        # Positional notation only: the scanner has no exponents.
        s = repr(v)
        if "e" in s or "E" in s:
            s = format(v, ".17f").rstrip("0")
            if s.endswith("."):
                s += "0"
        return s
    return str(v)


@dataclass
class Call:
    name: str
    args: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    def uint_arg(self, key: str):
        """(value, present). Raises TypeError on a non-integer value."""
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(
                f"could not convert {v!r} to uint64 in Call.uint_arg")
        return v & 0xFFFFFFFFFFFFFFFF, True

    def uint_slice_arg(self, key: str):
        """(values, present) of a list argument such as ids=[1, 2].
        Raises TypeError when it is not a list of integers."""
        if key not in self.args:
            return [], False
        v = self.args[key]
        if not isinstance(v, (list, tuple)) or any(
                isinstance(x, bool) or not isinstance(x, int) for x in v):
            raise TypeError(f"unexpected type in uint_slice_arg, val {v!r}")
        return [x & 0xFFFFFFFFFFFFFFFF for x in v], True

    def clone(self) -> "Call":
        return Call(self.name, dict(self.args),
                    [c.clone() for c in self.children])

    def is_inverse(self, row_label: str, column_label: str) -> bool:
        """True for a Bitmap() that names a column and no row: it reads
        the inverse view."""
        if self.name != "Bitmap":
            return False
        try:
            _, row_ok = self.uint_arg(row_label)
            _, col_ok = self.uint_arg(column_label)
        except TypeError:
            return False
        return col_ok and not row_ok

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        # A Cond serializes as `key >= 10`, everything else as key=value.
        parts += [f"{k} {v}" if isinstance(v, Cond)
                  else f"{k}={_fmt_value(v)}"
                  for k, v in sorted(self.args.items())]
        return f"{self.name}({', '.join(parts)})"


@dataclass
class Query:
    calls: list = field(default_factory=list)

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)
