from . import ops
from .ops import sort_rows
from .ref import sort_rows_ref

__all__ = ["ops", "sort_rows", "sort_rows_ref"]
