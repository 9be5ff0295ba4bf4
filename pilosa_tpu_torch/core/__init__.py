"""Data model: Holder > Index > Frame > View > Fragment, and Row."""

from .fragment import Fragment
from .frame import Frame
from .holder import Holder
from .index import Index
from .row import Row
from .view import VIEW_INVERSE, VIEW_STANDARD, View

__all__ = ["Fragment", "Frame", "Holder", "Index", "Row", "View",
           "VIEW_INVERSE", "VIEW_STANDARD"]
