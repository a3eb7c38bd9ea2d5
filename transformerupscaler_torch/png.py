"""A PNG reader and writer in zlib, struct and numpy: what
``PIL.Image.open(path).convert("RGB")`` gives the JAX package's datasets
(data/datasets.py), and what ``PIL.Image.fromarray(a).save(path)`` writes,
for a host without PIL.

It reads 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), undoes all five row filters and
returns HWC uint8 RGB as ``convert("RGB")`` does: grey replicated to the
three channels, alpha dropped, palette indices looked up. Anything else (a
bit depth other than 8, interlacing, a chunk whose CRC does not match, a
truncated file) raises ``ValueError``.

The Average and Paeth filters make each byte depend on the decoded byte to
its left and the row above, so a row cannot be undone in one vector
operation. The decoder walks the image's anti-diagonals instead: the
pixels (r, x) with r + x = d depend only on diagonals d - 1 and d - 2, so
each step undoes one diagonal of every row at once, H + W - 1 steps in
all.

``write_png`` writes 8-bit RGB, non-interlaced, each row with the Sub
filter (the byte to its left subtracted), in one IDAT chunk: a file that
``read_png`` and PIL read back bit for bit, not PIL's own bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    """(type, payload) of every chunk, its CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """raw (h, 1 + w * bpp) filtered scanlines -> (h, w, bpp) uint8."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not 0-4")
    data = raw[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) <= 1:
        # None and Sub only (what write_png writes): each row on its own, a
        # running sum modulo 256 along it.
        out = data.copy()
        sub = ftype == 1
        out[sub] = np.cumsum(data[sub], axis=1, dtype=np.uint8)
        return out
    # Diagonal-major storage: s[d + 1, r + 1] holds pixel (r, x = d - r),
    # so that a step reads and writes contiguous rows; a zero row and
    # column and zeros off the image give the filters' zero borders.
    s = np.zeros((h + w, h + 1, bpp), np.int16)
    skew = np.zeros((h + w, h, bpp), np.uint8)
    for r in range(h):
        skew[r:r + w, r] = data[r]
    ft = ftype.astype(np.int16)[:, None]
    zero = np.zeros((1, bpp), np.int16)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = s[d, r0 + 1:r1 + 1]   # left: (r, x - 1), diagonal d - 1
        b = s[d, r0:r1]           # up: (r - 1, x), diagonal d - 1
        c = s[d - 1, r0:r1] if d else zero  # up-left, diagonal d - 2
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ft[r0:r1], (zero, a, b, (a + b) >> 1, paeth))
        s[d + 1, r0 + 1:r1 + 1] = (skew[d, r0:r1] + pred) & 0xFF
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = s[r + 1:r + 1 + w, r + 1]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG file contents -> (H, W, 3) uint8 RGB."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit is read")
    if ctype not in CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not 0, 2, 3, 4 or 6")
    if interlace:
        raise ValueError("interlaced PNGs are not read")
    if compression or filtering:
        raise ValueError("unknown PNG compression or filter method")
    bpp = CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{h * (1 + w * bpp)}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp),
                   h, w, bpp)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        # PIL reads a short palette as black beyond its last entry.
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)  # grey, grey + alpha


def read_png(path) -> np.ndarray:
    """The PNG at ``path`` as (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(hwc: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of a PNG file."""
    a = np.asarray(hwc)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png: (H, W, 3) uint8 RGB, got {a.dtype} "
                         f"{a.shape}")
    h, w, _ = a.shape
    if h == 0 or w == 0:
        raise ValueError(f"write_png: empty image {a.shape}")
    rows = a.reshape(h, 3 * w)
    sub = np.empty((h, 1 + 3 * w), np.uint8)
    sub[:, 0] = 1  # filter type Sub
    sub[:, 1:4] = rows[:, :3]
    sub[:, 4:] = rows[:, 3:] - rows[:, :-3]  # modulo 256
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(sub.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, hwc_uint8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to ``path`` as a PNG."""
    data = encode_png(hwc_uint8)
    with open(path, "wb") as f:
        f.write(data)
