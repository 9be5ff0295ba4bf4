"""Compile BSI value comparisons into plane-wise boolean ladders.

Trees are tuples: ``("leaf", row_id)``, ``("and"|"or"|"andnot",
*children)``, or the ``EMPTY`` sentinel, over rows of a field's
``bsi.<field>`` view. The device path turns a tree into the lowered
(shape, leaves) form with `to_shape`; the host oracle folds the same tree
over roaring Rows (`bsi.host.eval_rows`). The trees equal the JAX
package's, node for node.

The ladders are O'Neil's bit-sliced forms, built LSB to MSB:

    x > c   :  R_k = x_k AND R_{k-1}           when bit k of c is 1
               R_k = x_k OR  R_{k-1}           when bit k of c is 0
               seeded R = EMPTY (>) or base (>=)
    x < c   :  R_k = (base ANDNOT x_k) OR R    when bit k of c is 1
               R_k = R ANDNOT x_k              when bit k of c is 0
               seeded R = EMPTY (<) or base (<=)
    x == c  :  fold of AND x_k / ANDNOT x_k over all planes, from base

Signed comparisons split on the sign row: with pos = ex ANDNOT sign and
neg = ex AND sign, ``x > c`` for negative c is
``pos OR (neg AND |x| < |c|)``.
"""

from __future__ import annotations

from typing import List, Optional

from ..pql.ast import Cond
from .field import ROW_EXISTS, ROW_PLANE0, ROW_SIGN, FieldSchema

EMPTY = ("empty",)


def leaf(row_id: int) -> tuple:
    return ("leaf", row_id)


def t_and(a: tuple, b: tuple) -> tuple:
    if a == EMPTY or b == EMPTY:
        return EMPTY
    return ("and", a, b)


def t_or(a: tuple, b: tuple) -> tuple:
    if a == EMPTY:
        return b
    if b == EMPTY:
        return a
    return ("or", a, b)


def t_andnot(a: tuple, b: tuple) -> tuple:
    if a == EMPTY:
        return EMPTY
    if b == EMPTY:
        return a
    if a == b:
        return EMPTY
    return ("andnot", a, b)


_EX = leaf(ROW_EXISTS)
_SIGN = leaf(ROW_SIGN)

# The sign-split bases; the executor's Min/Max plane search starts from
# them.
POS = t_andnot(_EX, _SIGN)
NEG = t_and(_EX, _SIGN)


def _mag_cmp(schema: FieldSchema, op: str, c: int, base: tuple) -> tuple:
    """Unsigned magnitude comparison |x| <op> c restricted to `base` (the
    existing columns of one sign). c >= 0; op in {">", ">=", "<", "<="}."""
    d = schema.bit_depth
    if c >= (1 << d):
        return base if op in ("<", "<=") else EMPTY
    if c < 0:
        return base if op in (">", ">=") else EMPTY
    strict = op in (">", "<")
    r = EMPTY if strict else base
    if op in (">", ">="):
        for k in range(d):
            p = leaf(ROW_PLANE0 + k)
            r = t_and(p, r) if (c >> k) & 1 else t_or(p, r)
        # The OR steps reach outside the candidates: clamp back to base.
        return t_and(r, base)
    for k in range(d):
        p = leaf(ROW_PLANE0 + k)
        if (c >> k) & 1:
            r = t_or(t_andnot(base, p), r)
        else:
            r = t_andnot(r, p)
    return r


def _mag_eq(schema: FieldSchema, c: int, base: tuple) -> tuple:
    """|x| == c restricted to `base`."""
    if c < 0 or c >= (1 << schema.bit_depth):
        return EMPTY
    r = base
    for k in range(schema.bit_depth):
        p = leaf(ROW_PLANE0 + k)
        r = t_and(r, p) if (c >> k) & 1 else t_andnot(r, p)
    return r


def cond_tree(schema: FieldSchema, op: str, value) -> tuple:
    """The signed comparison tree of ``field <op> value`` over the field's
    bsi view. `value` is an int, or (low, high) for ``><`` (between,
    inclusive)."""
    if op == "><":
        low, high = value
        return t_and(cond_tree(schema, ">=", low),
                     cond_tree(schema, "<=", high))
    c = value
    if op == ">":
        if c >= 0:
            return t_and(POS, _mag_cmp(schema, ">", c, POS))
        return t_or(POS, t_and(NEG, _mag_cmp(schema, "<", -c, NEG)))
    if op == ">=":
        if c > 0:
            return t_and(POS, _mag_cmp(schema, ">=", c, POS))
        if c == 0:
            return POS
        return t_or(POS, t_and(NEG, _mag_cmp(schema, "<=", -c, NEG)))
    if op == "<":
        if c <= 0:
            return t_and(NEG, _mag_cmp(schema, ">", -c, NEG))
        return t_or(NEG, t_and(POS, _mag_cmp(schema, "<", c, POS)))
    if op == "<=":
        if c < 0:
            return t_and(NEG, _mag_cmp(schema, ">=", -c, NEG))
        return t_or(NEG, t_and(POS, _mag_cmp(schema, "<=", c, POS)))
    if op == "==":
        base = NEG if c < 0 else POS
        return _mag_eq(schema, abs(c), base)
    if op == "!=":
        return t_andnot(_EX, cond_tree(schema, "==", c))
    raise ValueError(f"unknown comparison operator {op!r}")


def to_shape(tree: tuple, frame: str, view: str,
             leaves: List[tuple]) -> list:
    """A cond tree as a lowered shape, appending (frame, view, row_id,
    required=False) leaves depth-first, the format of
    parallel.plan._lower_tree: a slice without a bsi fragment holds no
    values, so every leaf is optional. EMPTY lowers as ex ANDNOT ex, so a
    shape always has leaves."""
    if tree == EMPTY:
        tree = ("andnot", _EX, _EX)
    if tree[0] == "leaf":
        leaves.append((frame, view, tree[1], False))
        return ["leaf"]
    return [tree[0]] + [to_shape(t, frame, view, leaves) for t in tree[1:]]


def field_cond(c) -> Optional[tuple]:
    """The call's single field comparison as (field, Cond), or None when
    it has none or several."""
    found = [(k, v) for k, v in c.args.items() if isinstance(v, Cond)]
    return found[0] if len(found) == 1 else None


def lower_cond(holder, index: str, c, leaves: List[tuple]) -> Optional[list]:
    """Range(frame=f, field <op> N) as a lowered shape over the field's
    bsi view, or None (host path) when the call is not a single field
    comparison or its frame or field is unknown."""
    from ..parallel.plan import DEFAULT_FRAME

    fc = field_cond(c)
    if fc is None:
        return None
    fname, cond = fc
    idx = holder.index(index)
    if idx is None:
        return None
    frame = c.args.get("frame") or DEFAULT_FRAME
    f = idx.frame(frame)
    if f is None:
        return None
    schema = f.bsi_field(fname)
    if schema is None:
        return None
    tree = cond_tree(schema, cond.op, cond.value)
    return to_shape(tree, frame, schema.view, leaves)
