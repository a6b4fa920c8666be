"""A PNG reader and writer on ``zlib`` and numpy only.

The machine with the card has neither PIL nor cv2, so the port decodes and
writes its PNGs here. The reader takes 8-bit, non-interlaced images of
every colour type: grey, grey + alpha, RGB, RGBA and palette, with each of
the five row filters, and returns RGB uint8 HWC as the JAX package's
``load_image`` does (``cv2.imread(path, cv2.IMREAD_COLOR)``): alpha,
``tRNS`` included, is dropped, not composited, and grey is replicated into
three channels. An interlaced or a 16-bit image raises ``ValueError`` naming
the file. The writer writes 8-bit RGB.

The format (PNG specification, ISO/IEC 15948): an 8-byte signature, then
chunks of a 4-byte big-endian length, a 4-byte type, the data and a CRC-32
of type and data. ``IHDR`` (first) holds width, height, bit depth, colour
type, compression, filter and interlace method; ``PLTE`` the palette;
``IDAT`` chunks, concatenated, one zlib stream of the rows, each row a
filter byte and its filtered bytes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type: grey, RGB, palette, grey+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_IHDR_END = len(SIGNATURE) + 8 + 13  # the signature, IHDR's length and type, its data


def _ihdr(data: bytes, path: str) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of the ``IHDR``
    chunk at the start of ``data``."""
    if data[: len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    if len(data) < _IHDR_END or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:_IHDR_END])
    return w, h, depth, ctype, interlace


def image_size(path: str) -> Tuple[int, int]:
    """(h, w) from the ``IHDR`` chunk, reading only the file's first bytes."""
    with open(path, "rb") as f:
        w, h, _, _, _ = _ihdr(f.read(_IHDR_END), path)
    return h, w


def _chunks(data: bytes, path: str):
    """(type, data) of each chunk after the signature, up to ``IEND``."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: PNG chunk {kind!r} runs past the end of the file")
        yield kind, data[pos + 8: pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """The image bytes (H, W * bpp) uint8 of the filtered ``rows``.

    Rows filtered None, Sub or Up depend on their own row and the one above
    only bytewise, so each is undone as a whole row. Average and Paeth take
    the byte to the left as well, after it is undone; an image with such rows
    is undone along anti-diagonals of pixels (every pixel of one depends on
    pixels of the two before it only), all rows at once."""
    h, stride = rows.shape
    if filters.size and filters.max() > 4:
        raise ValueError(f"{path}: PNG row filter {int(filters.max())} is not one of 0-4")
    if not np.isin(filters, (3, 4)).any():
        out = np.empty_like(rows)
        prev = np.zeros(stride, np.uint8)
        for i in range(h):
            row, f = rows[i], filters[i]
            if f == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:
                row = row + prev
            out[i] = prev = row
        return out
    w = stride // bpp
    raw = rows.reshape(h, w, bpp).astype(np.int16)
    # one row and one column of zeros above and left: the filters' "outside"
    done = np.zeros((h + 1, w + 1, bpp), np.int16)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h - 1, s) + 1)
        x = s - r
        a, b, c = done[r + 1, x], done[r, x + 1], done[r, x]  # left, up, upper left
        pred = np.choose(filters[r, None], [np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)])
        done[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return done[1:, 1:].astype(np.uint8).reshape(h, stride)


def read(path: str) -> np.ndarray:
    """Decode ``path`` to RGB uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, interlace = _ihdr(data, path)
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not one of {sorted(CHANNELS)}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; this reader takes 8-bit images only")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; this reader takes non-interlaced only")
    idat, palette = [], None
    for kind, body in _chunks(data, path):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    bpp = CHANNELS[ctype]
    stride = w * bpp
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data does not inflate: {e}") from None
    if flat.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {flat.size} bytes, "
                         f"{h * (stride + 1)} expected for {w} x {h}")
    flat = flat[: h * (stride + 1)].reshape(h, stride + 1)
    img = _unfilter(flat[:, 1:], flat[:, 0], bpp, path).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        if img.size and img.max() >= len(palette):
            raise ValueError(f"{path}: palette index {int(img.max())} past the "
                             f"{len(palette)}-entry PLTE")
        return palette[img[..., 0]]
    if ctype in (0, 4):  # grey, grey + alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write(path: str, img: np.ndarray) -> None:
    """Write RGB uint8 (H, W, 3) ``img`` as an 8-bit RGB PNG (every row
    filter None, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: expected RGB uint8 (H, W, 3), got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 (None) first in each row
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
