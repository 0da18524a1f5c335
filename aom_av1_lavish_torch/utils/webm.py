"""WebM (Matroska) container I/O for AV1 streams.

Re-designs the reference's common/webmenc.cc / webmdec.cc surface in
Python: a minimal EBML muxer (Segment/Info/Tracks/Cluster/SimpleBlock,
V_AV1 codec, av1C CodecPrivate) and a demuxer that yields temporal-unit
payloads for decode_frame_obus.
"""

from __future__ import annotations

import struct

# EBML / Matroska element IDs (stored with their marker bits)
EBML = 0x1A45DFA3
SEGMENT = 0x18538067
INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
CLUSTER = 0x1F43B675
TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1


def _id_bytes(eid: int) -> bytes:
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _size_bytes(size: int) -> bytes:
    """EBML vint size: length marker + value."""
    for n in range(1, 9):
        if size < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | size).to_bytes(n, "big")
    raise ValueError("size too large")


def _elem(eid: int, payload: bytes) -> bytes:
    return _id_bytes(eid) + _size_bytes(len(payload)) + payload


def _uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return _elem(eid, v.to_bytes(n, "big"))


def _string(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


def av1_codec_private(sh) -> bytes:
    """AV1CodecConfigurationRecord (av1C) + sequence header config OBU."""
    from ..bitstream import headers as H
    from ..bitstream import constants as c
    from ..bitstream.bits import BitWriter
    b0 = 0x81  # marker | version 1
    b1 = ((sh.profile & 7) << 5) | (sh.seq_level_idx & 0x1F)
    b2 = ((0 << 7) | (int(sh.bit_depth > 8) << 6)
          | (int(sh.bit_depth == 12) << 5) | (sh.mono_chrome << 4)
          | (sh.subsampling_x << 3) | (sh.subsampling_y << 2) | 0)
    b3 = 0  # no initial_presentation_delay
    w = BitWriter()
    H.write_sequence_header(sh, w)
    w.write_bit(1)  # trailing bit
    w.byte_align()
    seq_obu = H.wrap_obu(c.OBU_SEQUENCE_HEADER, w.data())
    return bytes([b0, b1, b2, b3]) + seq_obu


def write_webm(path: str, temporal_units, sh, fps=(30, 1)) -> None:
    """Mux low-overhead temporal units into a WebM file (one cluster,
    SimpleBlocks at millisecond timecodes)."""
    frame_ms = 1000 * fps[1] // fps[0]
    blocks = bytearray()
    blocks += _uint(TIMECODE, 0)
    for i, tu in enumerate(temporal_units):
        hdr = b"\x81" + struct.pack(">h", i * frame_ms) + b"\x80"
        blocks += _elem(SIMPLE_BLOCK, hdr + tu)
    info = (_uint(TIMECODE_SCALE, 1_000_000)
            + _string(MUXING_APP, "aom_av1_lavish_tpu")
            + _string(WRITING_APP, "aom_av1_lavish_tpu"))
    video = _uint(PIXEL_WIDTH, sh.max_frame_width) + \
        _uint(PIXEL_HEIGHT, sh.max_frame_height)
    track = (_uint(TRACK_NUMBER, 1) + _uint(TRACK_UID, 1)
             + _uint(TRACK_TYPE, 1) + _string(CODEC_ID, "V_AV1")
             + _elem(CODEC_PRIVATE, av1_codec_private(sh))
             + _elem(VIDEO, video))
    segment = (_elem(INFO, info)
               + _elem(TRACKS, _elem(TRACK_ENTRY, track))
               + _elem(CLUSTER, bytes(blocks)))
    ebml = (_uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4)
            + _uint(0x42F3, 8) + _string(0x4282, "webm")
            + _uint(0x4287, 4) + _uint(0x4285, 2))
    with open(path, "wb") as f:
        f.write(_elem(EBML, ebml) + _elem(SEGMENT, segment))


# --- demux -----------------------------------------------------------------

def _read_vint(data: bytes, pos: int, keep_marker: bool):
    first = data[pos]
    n = 1
    mask = 0x80
    while n <= 8 and not (first & mask):
        mask >>= 1
        n += 1
    v = int.from_bytes(data[pos:pos + n], "big")
    unknown = False
    if not keep_marker:
        value_mask = (1 << (7 * n)) - 1
        v &= value_mask
        unknown = v == value_mask
    return v, pos + n, unknown


def _iter_elems(data: bytes, pos: int, end: int):
    while pos < end:
        eid, pos, _ = _read_vint(data, pos, keep_marker=True)
        size, pos, unknown = _read_vint(data, pos, keep_marker=False)
        if unknown:
            size = end - pos   # unknown size: runs to parent end
        yield eid, pos, min(pos + size, end)
        pos = min(pos + size, end)


def read_webm(path: str):
    """Yield temporal-unit payloads of the first AV1 track.  The av1C
    config OBUs (sequence header) are prepended to the first TU."""
    with open(path, "rb") as f:
        data = f.read()
    track_no = None
    codec_private = b""
    tus = []
    for eid, s, e in _iter_elems(data, 0, len(data)):
        if eid != SEGMENT:
            continue
        for eid2, s2, e2 in _iter_elems(data, s, e):
            if eid2 == TRACKS:
                for eid3, s3, e3 in _iter_elems(data, s2, e2):
                    if eid3 != TRACK_ENTRY:
                        continue
                    num, cid, priv = None, None, b""
                    for eid4, s4, e4 in _iter_elems(data, s3, e3):
                        if eid4 == TRACK_NUMBER:
                            num = int.from_bytes(data[s4:e4], "big")
                        elif eid4 == CODEC_ID:
                            cid = data[s4:e4].rstrip(b"\x00")
                        elif eid4 == CODEC_PRIVATE:
                            priv = data[s4:e4]
                    if cid == b"V_AV1" and track_no is None:
                        track_no = num
                        codec_private = priv
            elif eid2 == CLUSTER:
                for eid3, s3, e3 in _iter_elems(data, s2, e2):
                    blk = None
                    if eid3 == SIMPLE_BLOCK:
                        blk = (s3, e3)
                    elif eid3 == BLOCK_GROUP:
                        for eid4, s4, e4 in _iter_elems(data, s3, e3):
                            if eid4 == BLOCK:
                                blk = (s4, e4)
                    if blk is None:
                        continue
                    bs, be = blk
                    tno, p, _ = _read_vint(data, bs, keep_marker=False)
                    p += 3  # int16 timecode + flags
                    if track_no is None or tno == track_no:
                        tus.append(data[p:be])
    if tus and len(codec_private) > 4:
        # config OBUs follow the 4-byte av1C prefix
        tus[0] = codec_private[4:] + tus[0]
    return tus
