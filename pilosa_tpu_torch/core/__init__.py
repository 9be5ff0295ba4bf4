"""Data model: Holder > Index > Frame > View > Fragment, and Row; the
rank cache, the attribute stores, the time-quantum views and the WAL
policy (WalConfig)."""

from .attr import AttrStore
from .cache import LRUCache, RankCache
from .fragment import Fragment, TopOptions
from .frame import Frame
from .holder import Holder
from .index import Index
from .row import Row
from .timequantum import (TimeQuantum, parse_time_quantum, views_by_time,
                          views_by_time_range)
from .view import VIEW_INVERSE, VIEW_STANDARD, View
from .wal import WalConfig

__all__ = ["AttrStore", "Fragment", "Frame", "Holder", "Index",
           "LRUCache", "RankCache", "Row", "TimeQuantum", "TopOptions",
           "View", "VIEW_INVERSE", "VIEW_STANDARD", "WalConfig",
           "parse_time_quantum", "views_by_time", "views_by_time_range"]
