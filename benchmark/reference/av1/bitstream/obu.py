"""Annex-B and raw-OBU ("low overhead") stream file I/O.

Re-designs the reference's obudec.c / aomenc --obu/--annexb surface:
 * raw OBU streams: temporal units in low-overhead format, each OBU
   carrying its own size field, TUs separated by temporal delimiters
 * Annex B (AV1 spec Annex B): temporal_unit_size / frame_unit_size /
   obu_length leb128 framing

Both readers yield low-overhead TU byte strings that decode_frame_obus
consumes directly.
"""

from __future__ import annotations

from .bits import leb128_decode, leb128_encode
from . import constants as c

_FRAME_STARTERS = (c.OBU_FRAME, c.OBU_FRAME_HEADER)


def _obu_spans(data: bytes):
    """Yield (obu_type, full_obu_bytes) over a low-overhead TU."""
    pos = 0
    while pos < len(data):
        start = pos
        hdr = data[pos]
        obu_type = (hdr >> 3) & 0xF
        has_ext = (hdr >> 2) & 1
        has_size = (hdr >> 1) & 1
        pos += 1 + has_ext
        assert has_size, "low-overhead stream requires obu size fields"
        size, pos = leb128_decode(data, pos)
        pos += size
        yield obu_type, data[start:pos]


# --- raw OBU streams -------------------------------------------------------

def write_obu_file(path: str, temporal_units) -> None:
    """Concatenated low-overhead temporal units (aomenc --obu output)."""
    with open(path, "wb") as f:
        for tu in temporal_units:
            f.write(tu)


def read_obu_file(path: str):
    """Split a low-overhead stream at temporal delimiters; yields TUs."""
    with open(path, "rb") as f:
        data = f.read()
    cur = []
    for obu_type, full in _obu_spans(data):
        if obu_type == c.OBU_TEMPORAL_DELIMITER and cur:
            yield b"".join(cur)
            cur = []
        cur.append(full)
    if cur:
        yield b"".join(cur)


# --- Annex B ---------------------------------------------------------------

def write_annexb(path: str, temporal_units) -> None:
    """Annex-B framing (spec B.2): TU size / frame-unit size / obu_length.
    Frame units split at OBU_FRAME / OBU_FRAME_HEADER boundaries; leading
    TD / sequence-header / metadata OBUs attach to the following frame."""
    with open(path, "wb") as f:
        for tu in temporal_units:
            fus = []          # list of frame units, each a list of obus
            pending = []      # obus awaiting their frame starter
            for obu_type, full in _obu_spans(tu):
                if obu_type in _FRAME_STARTERS and any(
                        t in _FRAME_STARTERS
                        for t, _ in _obu_spans(b"".join(pending))):
                    fus.append(pending)
                    pending = []
                pending.append(full)
            if pending:
                fus.append(pending)
            out = bytearray()
            for fu in fus:
                body = b"".join(leb128_encode(len(o)) + o for o in fu)
                out += leb128_encode(len(body)) + body
            f.write(leb128_encode(len(out)) + bytes(out))


def _ensure_size_field(obu: bytes) -> bytes:
    """Rewrap one OBU so it carries a size field (annex-b inputs may
    omit it)."""
    hdr = obu[0]
    has_ext = (hdr >> 2) & 1
    has_size = (hdr >> 1) & 1
    if has_size:
        return obu
    head = obu[:1 + has_ext]
    payload = obu[1 + has_ext:]
    return bytes([hdr | 2]) + head[1:] + leb128_encode(len(payload)) \
        + payload


def annexb_tu_to_obus(data: bytes, pos: int = 0):
    """Convert one Annex-B temporal unit (starting at `pos`, including
    its leading temporal_unit_size) to low-overhead OBU bytes.  Returns
    (obu_bytes, next_pos) — the AV1D_SET_IS_ANNEXB input adapter."""
    tu_size, pos = leb128_decode(data, pos)
    tu_end = pos + tu_size
    obus = []
    while pos < tu_end:
        fu_size, pos = leb128_decode(data, pos)
        fu_end = pos + fu_size
        while pos < fu_end:
            ln, pos = leb128_decode(data, pos)
            obus.append(_ensure_size_field(data[pos:pos + ln]))
            pos += ln
        pos = fu_end
    return b"".join(obus), tu_end


def read_annexb(path: str):
    """Yield low-overhead TU byte strings from an Annex-B file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        tu, pos = annexb_tu_to_obus(data, pos)
        yield tu
