"""Y4M (YUV4MPEG2) file read/write (reference behavior: common/y4minput.c).

Frames are planar numpy arrays (y, u, v) in uint8 (8-bit) or uint16
(10/12-bit, C420p10/C420p12 little-endian sample layout).
"""

from __future__ import annotations

import numpy as np


def write_y4m(path: str, frames, width: int, height: int,
              fps=(30, 1), subsampling: str = "420",
              bit_depth: int = 8, mono: bool = False) -> None:
    """frames: iterable of (y, u, v) planar arrays (uint8 or uint16);
    mono=True takes (y,) tuples and writes a Cmono stream."""
    if mono:
        tag = "mono" + (f"p{bit_depth}" if bit_depth > 8 else "")
    else:
        tag = {"420": "420jpeg", "422": "422", "444": "444"}[subsampling]
        if bit_depth > 8:
            tag = {"420": "420", "422": "422",
                   "444": "444"}[subsampling] + f"p{bit_depth}"
    dtype = "<u2" if bit_depth > 8 else np.uint8
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{width} H{height} F{fps[0]}:{fps[1]} "
                f"Ip A0:0 C{tag}\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for p in planes:
                f.write(np.ascontiguousarray(p).astype(dtype).tobytes())


def read_y4m(path: str):
    """Return (frames, width, height, subsampling); frames = list of
    (y, u, v).  10/12-bit files (C*p10/C*p12) yield uint16 planes."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        fields = header.decode().split()
        assert fields[0] == "YUV4MPEG2"
        width = height = None
        sub = "420"
        bit_depth = 8
        for fd in fields[1:]:
            if fd[0] == "W":
                width = int(fd[1:])
            elif fd[0] == "H":
                height = int(fd[1:])
            elif fd[0] == "C":
                cs = fd[1:]
                if cs.startswith("420"):
                    sub = "420"
                elif cs.startswith("422"):
                    sub = "422"
                elif cs.startswith("444"):
                    sub = "444"
                elif cs.startswith("mono"):
                    sub = "mono"
                if cs.endswith("p10"):
                    bit_depth = 10
                elif cs.endswith("p12"):
                    bit_depth = 12
        sx = 2 if sub in ("420", "422") else 1
        sy = 2 if sub == "420" else 1
        cw, ch = (width + sx - 1) // sx, (height + sy - 1) // sy
        if sub == "mono":
            cw = ch = 0
        nbytes = 2 if bit_depth > 8 else 1
        dtype = "<u2" if bit_depth > 8 else np.uint8
        frames = []
        while True:
            line = b""
            ch_ = f.read(1)
            if not ch_:
                break
            line += ch_
            while not line.endswith(b"\n"):
                line += f.read(1)
            assert line.startswith(b"FRAME")
            y = np.frombuffer(f.read(width * height * nbytes), dtype=dtype)
            if sub == "mono":
                frames.append((y.reshape(height, width), None, None))
                continue
            u = np.frombuffer(f.read(cw * ch * nbytes), dtype=dtype)
            v = np.frombuffer(f.read(cw * ch * nbytes), dtype=dtype)
            frames.append((y.reshape(height, width), u.reshape(ch, cw),
                           v.reshape(ch, cw)))
        return frames, width, height, sub
