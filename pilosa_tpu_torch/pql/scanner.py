"""PQL tokenizer.

Produces (Token, Pos, literal) triples. Identifiers start with a letter
and continue with [A-Za-z0-9_.-]; numbers allow a leading '-' and one
'.'; strings are single- or double-quoted with \\n, \\\\, \\", \\'
escapes (anything else is BADSTRING).
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Token(enum.Enum):
    ILLEGAL = "ILLEGAL"
    EOF = "EOF"
    WS = "WS"
    IDENT = "IDENT"
    STRING = "STRING"
    BADSTRING = "BADSTRING"
    INTEGER = "INTEGER"
    FLOAT = "FLOAT"
    EQ = "="
    COMMA = ","
    LPAREN = "("
    RPAREN = ")"
    LBRACK = "["
    RBRACK = "]"


class Pos(NamedTuple):
    line: int  # zero-based
    char: int  # zero-based


_ESCAPES = {"n": "\n", "\\": "\\", '"': '"', "'": "'"}

_SINGLE = {"=": Token.EQ, ",": Token.COMMA, "(": Token.LPAREN,
           ")": Token.RPAREN, "[": Token.LBRACK, "]": Token.RBRACK}


def _is_letter(ch: str) -> bool:
    return ("a" <= ch <= "z") or ("A" <= ch <= "Z")


def _is_digit(ch: str) -> bool:
    return "0" <= ch <= "9"


def _is_ident_char(ch: str) -> bool:
    return _is_letter(ch) or _is_digit(ch) or ch in "_-."


class Scanner:
    """Single-pass tokenizer with line/char positions."""

    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.line = 0
        self.char = 0

    def _peek(self) -> str:
        return self.src[self.i] if self.i < len(self.src) else ""

    def _read(self) -> str:
        ch = self._peek()
        if ch:
            self.i += 1
            if ch == "\n":
                self.line += 1
                self.char = 0
            else:
                self.char += 1
        return ch

    def _read_while(self, pred) -> str:
        out = []
        while self._peek() and pred(self._peek()):
            out.append(self._read())
        return "".join(out)

    def scan(self):
        """Next (Token, Pos, literal)."""
        pos = Pos(self.line, self.char)
        ch = self._peek()
        if ch == "":
            return Token.EOF, pos, ""
        if ch.isspace():
            return Token.WS, pos, self._read_while(str.isspace)
        if _is_letter(ch):
            return Token.IDENT, pos, self._read_while(_is_ident_char)
        if _is_digit(ch) or ch == "-":
            return self._scan_number(pos)
        if ch in "\"'":
            return self._scan_string(pos)
        self._read()
        return _SINGLE.get(ch, Token.ILLEGAL), pos, ch

    def _scan_number(self, pos):
        lit = [self._read()]  # digit or '-'
        tok = Token.INTEGER
        while True:
            ch = self._peek()
            if _is_digit(ch):
                lit.append(self._read())
            elif ch == "." and tok is Token.INTEGER:
                tok = Token.FLOAT
                lit.append(self._read())
            else:
                return tok, pos, "".join(lit)

    def _scan_string(self, pos):
        ending = self._read()
        out = []
        while True:
            ch = self._read()
            if ch == ending:
                return Token.STRING, pos, "".join(out)
            if ch in ("", "\n"):
                return Token.BADSTRING, pos, "".join(out)
            if ch == "\\":
                nxt = self._read()
                if nxt not in _ESCAPES:
                    return Token.BADSTRING, pos, "".join(out)
                out.append(_ESCAPES[nxt])
            else:
                out.append(ch)

    def tokens(self):
        """All tokens through EOF (inclusive), whitespace skipped."""
        out = []
        while True:
            tok, pos, lit = self.scan()
            if tok is not Token.WS:
                out.append((tok, pos, lit))
            if tok is Token.EOF:
                return out
