"""8-bit PNG encode and decode with the standard library's zlib and numpy.

The port renders, writes procedural scenes and loads glTF textures
without Pillow. Decoding covers what glTF assets and Pillow's encoder
produce for 8-bit images: grey, grey+alpha, RGB, RGBA and palette
colour types, non-interlaced, with all five row filters. Every image
decodes to (H, W, 4) uint8 RGBA, as Pillow's `convert("RGBA")` gives.

Encoding writes RGB or RGBA the way Pillow's PNG writer does with its
defaults, so the bytes are Pillow's: per row the first filter of None,
Up, Sub and Paeth with the least sum of |byte| (bytes read as signed),
zlib level 6 with memLevel 9 and the Z_FILTERED strategy, and IDAT
chunks of max(65536, 4 * width) bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _filtered_rows(img: np.ndarray) -> bytes:
    """Each row behind its filter byte, the filter chosen as Pillow's
    encoder chooses it (libImaging/ZipEncode.c)."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, c:] = cur[:, :-c]
    upleft = np.zeros_like(cur)
    upleft[:, c:] = up[:, :-c]
    a, b, cc = (x.astype(np.int16) for x in (left, up, upleft))
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc)).astype(np.uint8)
    # candidates in the order Pillow tries them: None, Up, Sub, Paeth
    cands = np.stack([cur, cur - up, cur - left, cur - pred])
    signed = cands.astype(np.int16)
    cost = np.where(signed < 128, signed, 256 - signed).sum(axis=2)
    pick = np.argmin(cost, axis=0)  # the first of equal sums, as Pillow keeps it
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = np.array([0, 2, 1, 4], np.uint8)[pick]
    rows[:, 1:] = cands[pick, np.arange(h)]
    return rows.tobytes()


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes, as Pillow writes them."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {img.shape}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_filtered_rows(img)) + z.flush()
    step = max(65536, 4 * w)
    idat = b"".join(_chunk(b"IDAT", data[i:i + step]) for i in range(0, len(data), step))
    return _SIGNATURE + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the per-row filters (PNG spec section 9)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    rows = data.reshape(h, stride + 1)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth depend on the decoded left byte
            cur = np.zeros(stride, np.int64)
            ln = line.astype(np.int64)
            up = prior.astype(np.int64)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, int(up[i]), int(up[i - bpp]) if i >= bpp else 0)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = trns = None
    w = h = color_type = None
    while pos < len(blob):
        (length,) = struct.unpack_from(">I", blob, pos)
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", data)
            if depth != 8 or interlace != 0 or color_type not in _CHANNELS:
                raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                                 f"{color_type}, interlace {interlace}")
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    rgba = np.empty((h, w, 4), np.uint8)
    if color_type == 3:
        lut = np.full((256, 4), 255, np.uint8)
        lut[:palette.shape[0], :3] = palette
        if trns is not None:
            lut[:trns.shape[0], 3] = trns
        return lut[px[..., 0]]
    if color_type in (0, 4):
        rgba[..., :3] = px[..., :1]
        rgba[..., 3] = px[..., 1] if color_type == 4 else 255
    else:
        rgba[..., :3] = px[..., :3]
        rgba[..., 3] = px[..., 3] if color_type == 6 else 255
    if trns is not None and color_type in (0, 2):
        key = np.frombuffer(trns.tobytes(), ">u2").astype(np.uint8)
        match = (px[..., :len(key)] == key).all(axis=-1)
        rgba[..., 3] = np.where(match, 0, rgba[..., 3])
    return rgba


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
