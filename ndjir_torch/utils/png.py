"""A minimal PNG writer: 8-bit grayscale or RGB, no interlace, filter type
0 on every row, one zlib-compressed IDAT chunk (PNG specification, ISO/IEC
15948).  The port writes its images with it because the card's machine has
no image library (imageio, PIL, cv2)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 image, (H, W) or (H, W, 1) gray or (H, W, 3)
    RGB."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"a uint8 image expected, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"an (H, W) or (H, W, 3) image expected, got "
                         f"{img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image to ``path`` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
