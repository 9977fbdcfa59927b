"""A minimal PNG writer and reader (PNG specification, ISO/IEC 15948).

The writer makes 8-bit grayscale or RGB files, not interlaced, filter type 0
on every row, one zlib-compressed IDAT chunk.  The reader takes what image
libraries write and IDR scene folders hold: 8-bit samples, not interlaced,
color types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA),
any of the five row filters, the IDAT data split over any number of chunks,
every chunk's CRC checked.  It returns what ``imageio.imread`` returns for
such a file: (H, W) for gray, (H, W, 2|3|4) otherwise, a palette image as
RGB.  Anything else raises ``ValueError`` naming what it met.  The port
reads and writes its images with these because the card's machine has no
image library (imageio, PIL, cv2)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def _chunks(data: bytes):
    """(kind, payload) of every chunk, each CRC checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: it starts with {data[:8]!r}")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG file: no IEND chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG file in its {kind!r} chunk")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC check")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _unfilter(filtered: np.ndarray, ftypes: np.ndarray, W: int,
              bpp: int) -> np.ndarray:
    """Undo the row filters: filtered (H, W, bpp) bytes, ftypes (H,) in
    0..4 -> the (H, W, bpp) samples.  A sample depends on its left, upper
    and upper-left neighbours, so the anti-diagonals r + x = d are decoded
    one after another, each at once: in the skewed layout S[r, d] =
    out[r, d - r] a diagonal is one column and its neighbours are the two
    columns before it."""
    H = len(filtered)
    D = H + W - 1
    # S[1 + r, 2 + d]: one zero row above, two zero columns on the left
    S = np.zeros((H + 1, D + 2, bpp), np.int16)
    r = np.arange(H)[:, None]
    d = r + np.arange(W)[None, :]
    raw = np.zeros((H, D, bpp), np.int16)
    raw[r, d] = filtered
    # per row, 1 where it uses filter 1 (Sub), 2 (Up), 3 (Average), 4 (Paeth)
    sub, up, avg, paeth_ = ((ftypes == t).astype(np.int16)[:, None]
                            for t in (1, 2, 3, 4))
    for k in range(D):
        r0, r1 = max(0, k - W + 1), min(H, k + 1)
        a = S[1 + r0:1 + r1, 1 + k]          # left:       out[r, x - 1]
        b = S[r0:r1, 1 + k]                  # up:         out[r - 1, x]
        c = S[r0:r1, k]                      # up-left:    out[r - 1, x - 1]
        # Paeth: the one of a, b, c nearest p = a + b - c, ties to a then b
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - c - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (sub[r0:r1] * a + up[r0:r1] * b
                + avg[r0:r1] * ((a + b) >> 1) + paeth_[r0:r1] * paeth)
        S[1 + r0:1 + r1, 2 + k] = (raw[r0:r1, k] + pred) & 0xFF
    return S[1 + r, 2 + d].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 image of a PNG file's bytes (see the module docstring)."""
    header = palette = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    W, H, depth, color_type, compression, filter_method, interlace = header
    if color_type not in _CHANNELS:
        raise ValueError(f"PNG color type {color_type} is not a valid one")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if interlace != 0:
        raise ValueError(f"interlaced PNG (method {interlace}) is not "
                         "supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"PNG compression method {compression} / filter "
                         f"method {filter_method} is not a valid one")
    if color_type == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    bpp = _CHANNELS[color_type]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not decompress: {e}") from e
    stride = 1 + W * bpp
    if len(raw) != H * stride:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, "
                         f"{H * stride} expected for {W}x{H}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride)
    ftypes = rows[:, 0]
    if (ftypes > 4).any():
        raise ValueError(f"PNG row filter type {int(ftypes.max())} is not "
                         "a valid one")
    img = _unfilter(rows[:, 1:].reshape(H, W, bpp), ftypes, W, bpp)
    if color_type == 3:
        if img.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index outside the palette")
        return palette[img[..., 0]]
    return img[..., 0] if bpp == 1 else img


def read_png(path: str) -> np.ndarray:
    """The uint8 image of the PNG file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read())
