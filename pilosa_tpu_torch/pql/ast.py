"""PQL AST. Argument values carry the parser's Python types: int,
float, bool, None, str, list."""

from __future__ import annotations

from dataclasses import dataclass, field


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


@dataclass
class Query:
    calls: list = field(default_factory=list)
