"""Host roaring bitmaps: array and bitmap containers, and the reference
file format (cookie 12346)."""

from .bitmap import ARRAY_MAX_SIZE, BITMAP_N, Bitmap, Container

__all__ = ["ARRAY_MAX_SIZE", "BITMAP_N", "Bitmap", "Container"]
