"""Recursive-descent PQL parser.

call = IDENT '(' [child-calls] [, key=value ...] ')'. Children are
detected by IDENT + LPAREN lookahead; duplicate argument keys are
errors. A key may take a comparison instead of `=` (`val >= 10`,
`val >< [lo, hi]`), parsed into a Cond.
"""

from __future__ import annotations

from typing import Optional

from .ast import Call, Cond, Query
from .scanner import Pos, Scanner, Token

_IDENT_VALUES = {"true": True, "false": False, "null": None}

# Comparison tokens between an argument key and its value, to their
# Cond.op spelling.
_COND_TOKENS = {Token.GT: ">", Token.GTE: ">=", Token.LT: "<",
                Token.LTE: "<=", Token.EQEQ: "==", Token.NEQ: "!=",
                Token.BETWEEN: "><"}


class ParseError(Exception):
    def __init__(self, message: str, pos: Optional[Pos] = None):
        self.message = message
        self.pos = pos
        loc = f" at line={pos.line}, char={pos.char}" if pos else ""
        super().__init__(f"{message}{loc}")


class Parser:
    """Parses a full PQL query string into a Query."""

    def __init__(self, src: str):
        self.toks = Scanner(src).tokens()  # ends with EOF
        self.i = 0

    def _peek(self):
        return self.toks[self.i]

    def _next(self):
        tok = self.toks[self.i]
        if tok[0] is not Token.EOF:
            self.i += 1
        return tok

    def _expect(self, want: Token):
        tok, pos, lit = self._next()
        if tok is not want:
            raise ParseError(f"expected {want.value}, found {lit!r}", pos)

    def parse(self) -> Query:
        q = Query()
        while self._peek()[0] is not Token.EOF:
            q.calls.append(self._parse_call())
        if not q.calls:
            raise ParseError(
                "unexpected EOF: query must have at least one call")
        return q

    def _parse_call(self) -> Call:
        tok, pos, lit = self._next()
        if tok is not Token.IDENT:
            raise ParseError(f"expected identifier, found: {lit}", pos)
        call = Call(name=lit)
        self._expect(Token.LPAREN)
        call.children = self._parse_children()
        tok, pos, lit = self._peek()
        if tok is Token.RPAREN:
            self._next()
            return call
        if tok is Token.COMMA:
            self._next()
        elif tok is not Token.IDENT:
            raise ParseError(
                f"expected comma, right paren, or identifier, found {lit!r}",
                pos)
        call.args = self._parse_args()
        self._expect(Token.RPAREN)
        return call

    def _parse_children(self) -> list:
        children = []
        while True:
            if (self._peek()[0] is not Token.IDENT
                    or self.toks[self.i + 1][0] is not Token.LPAREN):
                return children
            children.append(self._parse_call())
            tok, pos, lit = self._peek()
            if tok is Token.RPAREN:
                return children
            if tok is not Token.COMMA:
                raise ParseError(
                    f"expected comma or right paren, found {lit!r}", pos)
            self._next()

    def _parse_args(self) -> dict:
        args: dict = {}
        while True:
            tok, pos, key = self._next()
            if tok is not Token.IDENT:
                raise ParseError(f"expected argument key, found {key!r}", pos)
            tok, pos, lit = self._next()
            if tok in _COND_TOKENS:
                value = self._parse_cond(_COND_TOKENS[tok], pos)
            elif tok is Token.EQ:
                value = self._parse_value()
            else:
                raise ParseError(f"expected equals sign, found {lit!r}", pos)
            if key in args:
                raise ParseError(f"argument key already used: {key}", pos)
            args[key] = value
            tok, pos, lit = self._peek()
            if tok is Token.RPAREN:
                return args
            if tok is not Token.COMMA:
                raise ParseError(
                    f"expected comma or right paren, found {lit!r}", pos)
            self._next()

    def _parse_cond(self, op: str, pos) -> Cond:
        value = self._parse_value()
        if op == "><":
            if (not isinstance(value, list) or len(value) != 2
                    or any(isinstance(x, bool) or not isinstance(x, int)
                           for x in value)):
                raise ParseError("between (><) requires [low, high] integers",
                                 pos)
        elif isinstance(value, bool) or not isinstance(value, int):
            raise ParseError(f"comparison {op} requires an integer value",
                             pos)
        return Cond(op, value)

    def _parse_value(self):
        tok, pos, lit = self._next()
        if tok is Token.IDENT:
            return _IDENT_VALUES.get(lit, lit)
        if tok is Token.STRING:
            return lit
        if tok is Token.INTEGER:
            return int(lit)
        if tok is Token.FLOAT:
            return float(lit)
        if tok is Token.LBRACK:
            return self._parse_list()
        raise ParseError(f"invalid argument value: {lit!r}", pos)

    def _parse_list(self) -> list:
        values = []
        while True:
            tok, pos, lit = self._next()
            if tok is Token.IDENT:
                values.append(_IDENT_VALUES.get(lit, lit))
            elif tok is Token.STRING:
                values.append(lit)
            elif tok is Token.INTEGER:
                values.append(int(lit))
            else:
                raise ParseError(f"invalid list value: {lit!r}", pos)
            tok, pos, lit = self._next()
            if tok is Token.RBRACK:
                return values
            if tok is not Token.COMMA:
                raise ParseError(f"expected comma, found {lit!r}", pos)


def parse_string(src: str) -> Query:
    return Parser(src).parse()
