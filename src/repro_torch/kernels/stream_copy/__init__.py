from . import ops
from .ops import stream_copy, stream_scale_add
from .ref import stream_copy_ref, stream_scale_add_ref

__all__ = ["ops", "stream_copy", "stream_scale_add", "stream_copy_ref",
           "stream_scale_add_ref"]
