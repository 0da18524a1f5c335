"""IVF container read/write (reference behavior: common/ivfenc.c, ivfdec.c).

32-byte file header ("DKIF", fourcc AV01) + per-frame 12-byte headers.
"""

from __future__ import annotations

import struct
from typing import Iterator


def write_ivf(path: str, frames: "list[tuple[bytes, int]]", width: int,
              height: int, fps_num: int = 30, fps_den: int = 1) -> None:
    """frames: list of (payload, pts)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, b"AV01",
                            width, height, fps_num, fps_den, len(frames)))
        for payload, pts in frames:
            f.write(struct.pack("<IQ", len(payload), pts))
            f.write(payload)


def read_ivf(path: str) -> Iterator[tuple[bytes, int]]:
    with open(path, "rb") as f:
        hdr = f.read(32)
        magic, _ver, hdr_sz, fourcc = struct.unpack("<4sHH4s", hdr[:12])
        assert magic == b"DKIF" and fourcc in (b"AV01",), (magic, fourcc)
        f.seek(hdr_sz)
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                return
            size, pts = struct.unpack("<IQ", fh)
            yield f.read(size), pts


def ivf_dims(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        hdr = f.read(32)
    w, h = struct.unpack("<HH", hdr[12:16])
    return w, h
