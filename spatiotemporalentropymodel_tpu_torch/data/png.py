"""PNG files, read and written with the standard library and NumPy.

The JAX package reads and writes every image through PIL, as
``np.asarray(Image.open(path).convert("RGB"))`` and
``Image.fromarray(arr).save(path)``; the port has no PIL and this module
stands in its place:

- ``read_png(path)`` → (H, W, 3) uint8: 8-bit gray, gray + alpha, RGB, RGBA,
  and palette or gray at 1, 2, 4 or 8 bits (the depths PIL's writer uses for
  small palettes); alpha and a palette's transparency are dropped, as
  ``convert("RGB")`` drops them. 16-bit and interlaced files raise, as does
  anything that is not a PNG.
- ``write_png(path, rgb)``: 8-bit RGB, every row with the Up filter, zlib at
  its default level.

Rows filtered with Average or Paeth depend on the byte to their left, so
the reader undoes the filters on anti-diagonals of pixel cells: every cell
of one diagonal depends only on the two before it, and a 1080p frame takes
H + W NumPy steps rather than H·W Python ones.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int):
    """Undo the per-row filters (PNG spec §9) of ``raw``, h rows of one
    filter byte and ``row_bytes`` bytes; ``bpp`` is the bytes per complete
    pixel (1 below 8 bits). Returns (h, row_bytes) uint8."""
    raw = raw.reshape(h, row_bytes + 1)
    kinds = raw[:, 0].astype(np.int64)
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    filt = raw[:, 1:]
    if not np.isin(kinds, (3, 4)).any():  # None, Sub, Up: row by row
        out = np.empty((h, row_bytes), np.uint8)
        prior = np.zeros(row_bytes, np.uint8)
        for r in range(h):
            row = filt[r]
            if kinds[r] == 1:
                cells = row.reshape(-1, bpp)
                row = np.cumsum(cells, axis=0, dtype=np.uint8).reshape(-1)
            elif kinds[r] == 2:
                row = row + prior
            out[r] = row
            prior = out[r]
        return out
    # Average or Paeth somewhere: anti-diagonals of (row, pixel cell). A
    # cell needs its left, upper and upper-left cells, all on the two
    # diagonals before it. ``rec`` has a zero row on top and a zero cell on
    # the left, the PNG spec's out-of-image neighbours.
    cols = row_bytes // bpp
    cells = filt.reshape(h, cols, bpp).astype(np.int32)
    rec = np.zeros((h + 1, cols + 1, bpp), np.int32)
    for t in range(h + cols - 1):
        r = np.arange(max(0, t - cols + 1), min(h, t + 1))
        c = t - r
        a = rec[r + 1, c]  # left
        b = rec[r, c + 1]  # up
        ul = rec[r, c]  # upper left
        k = kinds[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, 0))
        pred = np.where(k == 3, (a + b) >> 1, pred)
        pred = np.where(k == 4, _paeth(a, b, ul), pred)
        rec[r + 1, c + 1] = (cells[r, c] + pred) & 0xFF
    return rec[1:, 1:].reshape(h, row_bytes).astype(np.uint8)


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, row_bytes) of packed samples below 8 bits → (h, w) values."""
    if depth == 8:
        return rows[:, :w]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w]


def read_png(path) -> np.ndarray:
    """The image at ``path`` as (H, W, 3) uint8 RGB, equal to PIL's
    ``np.asarray(Image.open(path).convert("RGB"))``."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (the port reads PNG only)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">2I5B", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported (8-bit only)")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"{path}: bit depth {depth} is not valid for PNG "
                         f"colour type {color}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    ch = _CHANNELS[color]
    row_bytes = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (row_bytes + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"expected {h * (row_bytes + 1)}")
    rows = _unfilter(raw, h, row_bytes, max(1, ch * depth // 8))
    if depth < 8:
        vals = _unpack_bits(rows, w, depth)
        if color == 3:
            return _apply_palette(vals, palette, path)
        gray = (vals.astype(np.int32) * 255 // ((1 << depth) - 1))
        return np.repeat(gray.astype(np.uint8)[..., None], 3, axis=2)
    px = rows.reshape(h, w, ch)
    if color == 3:
        return _apply_palette(px[..., 0], palette, path)
    if color in (0, 4):  # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _apply_palette(idx: np.ndarray, palette, path) -> np.ndarray:
    if palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    full = np.zeros((256, 3), np.uint8)  # entries past the palette: black
    full[:len(palette)] = palette
    return full[idx]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, rgb) -> None:
    """Write (H, W, 3) uint8 ``rgb`` as an 8-bit RGB PNG, every row with the
    Up filter (each byte less the byte above it)."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3)
    up = np.empty_like(rows)
    up[:1] = rows[:1]
    np.subtract(rows[1:], rows[:-1], out=up[1:])  # uint8 wraps mod 256
    raw = np.empty((h, w * 3 + 1), np.uint8)
    raw[:, 0] = 2
    raw[:, 1:] = up
    Path(path).write_bytes(
        SIGNATURE
        + _chunk(b"IHDR", struct.pack(">2I5B", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + _chunk(b"IEND", b""))
