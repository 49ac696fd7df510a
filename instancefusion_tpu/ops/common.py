"""Small shared op helpers."""

from __future__ import annotations


def decimate(arr, s: int):
    """`arr[::s, ::s]` over the two leading axes, cropped to full windows.

    Trailing rows/cols that don't fill a full stride window are cropped
    (floor-division shapes).
    """
    if s == 1:
        return arr
    h, w = arr.shape[:2]
    rest = arr.shape[2:]
    hs, ws = h // s, w // s
    arr = arr[: hs * s, : ws * s]
    return arr.reshape((hs, s, ws, s) + rest)[:, 0, :, 0]
