"""PQL: scanner, parser and AST."""

from .ast import Call, Cond, Query
from .parser import ParseError, Parser, parse_string

__all__ = ["Call", "Cond", "ParseError", "Parser", "Query", "parse_string"]
