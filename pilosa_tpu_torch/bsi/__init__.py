"""Bit-sliced indexing: integer fields over bitmap plane rows.

`field` defines the schema and row layout of a ``bsi.<field>`` view;
`lower` compiles value comparisons into the plane-ladder trees both
paths share; `host` is the exact roaring fold.
"""

from .field import (BSI_VIEW_PREFIX, MAX_BIT_DEPTH, ROW_EXISTS, ROW_PLANE0,
                    ROW_SIGN, FieldNotFoundError, FieldSchema,
                    FieldValueError)
from .lower import cond_tree, lower_cond, to_shape

__all__ = ["BSI_VIEW_PREFIX", "MAX_BIT_DEPTH", "ROW_EXISTS", "ROW_PLANE0",
           "ROW_SIGN", "FieldNotFoundError", "FieldSchema",
           "FieldValueError", "cond_tree", "lower_cond", "to_shape"]
