"""Uncompressed bit I/O for AV1 headers (spec §4: f(n), uvlc, leb128, su, ns).

AV1 frame/sequence headers are plain big-endian bitfields, not arithmetic
coded (reference behavior: aom_dsp/bitwriter_buffer.c, aom_dsp/bitreader_buffer.c).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (aom_wb_write_* semantics)."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.bit_offset = 0  # total bits written

    def write_bit(self, bit: int) -> None:
        off = self.bit_offset
        p = off >> 3
        q = 7 - (off & 7)
        if p == len(self.buf):
            self.buf.append(0)
        if bit:
            self.buf[p] |= 1 << q
        self.bit_offset = off + 1

    def write_literal(self, data: int, bits: int) -> None:
        """f(bits): unsigned big-endian."""
        assert 0 <= data < (1 << bits), (data, bits)
        for b in range(bits - 1, -1, -1):
            self.write_bit((data >> b) & 1)

    def write_inv_signed_literal(self, data: int, bits: int) -> None:
        """su(1+bits): literal in two's-complement-ish form (sign embedded)."""
        self.write_literal(data & ((1 << (bits + 1)) - 1), bits + 1)

    def write_uvlc(self, value: int) -> None:
        """uvlc(): Exp-Golomb style (spec 4.10.3)."""
        shifted = value + 1
        leading = shifted.bit_length() - 1
        for _ in range(leading):
            self.write_bit(0)
        self.write_literal(shifted, leading + 1)

    def write_ns(self, value: int, n: int) -> None:
        """ns(n): non-symmetric value in [0, n) (spec 4.10.7)."""
        w = n.bit_length()
        m = (1 << w) - n
        if value < m:
            self.write_literal(value, w - 1)
        else:
            extra = value - m
            self.write_literal(m + (extra >> 1), w - 1)
            self.write_bit(extra & 1)

    def byte_align(self) -> None:
        while self.bit_offset & 7:
            self.write_bit(0)

    def data(self) -> bytes:
        return bytes(self.buf)


class BitReader:
    """MSB-first bit reader (aom_rb_read_* semantics)."""

    def __init__(self, data: bytes, bit_offset: int = 0) -> None:
        self.buf = data
        self.bit_offset = bit_offset

    def read_bit(self) -> int:
        off = self.bit_offset
        self.bit_offset = off + 1
        return (self.buf[off >> 3] >> (7 - (off & 7))) & 1

    def read_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.read_bit()
        return v

    def read_inv_signed_literal(self, bits: int) -> int:
        v = self.read_literal(bits + 1)
        sign_bit = 1 << bits
        return (v & (sign_bit - 1)) - (v & sign_bit)

    def read_uvlc(self) -> int:
        leading = 0
        while self.read_bit() == 0:
            leading += 1
            assert leading < 32
        if leading == 0:
            return 0
        return (1 << leading) - 1 + self.read_literal(leading)

    def read_ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.read_literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.read_bit()

    def byte_align(self) -> None:
        self.bit_offset = (self.bit_offset + 7) & ~7


def leb128_encode(value: int) -> bytes:
    """leb128(): unsigned little-endian base-128 (spec 4.10.5)."""
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def leb128_decode(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Return (value, new_pos)."""
    value = 0
    for i in range(8):
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not (byte & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")
