"""PQL: scanner, parser and AST."""

from .ast import Call, Query
from .parser import ParseError, Parser, parse_string

__all__ = ["Call", "ParseError", "Parser", "Query", "parse_string"]
