"""AV1 multi-symbol range coder (Daala ``od_ec`` semantics), host reference.

This module is the *bit-exactness anchor* of the framework: every symbol in
an AV1 tile bytestream is coded with this arithmetic.  The interval-split
formulas are normative (AV1 spec §8.2; reference behavior:
``aom_dsp/entenc.c``, ``aom_dsp/entdec.c``, ``aom_dsp/prob.h:110`` for CDF
adaptation).  The carry/flush machinery here is our own formulation with the
same on-wire result.

Conventions (matching the AV1 spec and the reference tables):
  * CDFs are stored *inverted* ("icdf"): entry ``i`` holds
    ``32768 - cum_prob(symbol <= i)``, monotonically non-increasing, and the
    last real entry is 0.  An extra trailing slot holds the adaptation
    counter.
  * Probabilities are Q15 (``CDF_PROB_TOP == 1 << 15``).

A batched JAX/XLA formulation of the same arithmetic lives in
``entropy_jax.py``; a native C fast path in ``runtime/``.  All three are
cross-checked in ``tests/test_entropy.py``.
"""

from __future__ import annotations

import numpy as np

CDF_PROB_BITS = 15
CDF_PROB_TOP = 1 << CDF_PROB_BITS  # 32768
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
# Decoder window is 32 bits; encoder accumulates into a 64-bit window.
DEC_WIN_BITS = 32
_LOTS_OF_BITS = 0x4000


def icdf(cum: "list[int] | np.ndarray") -> np.ndarray:
    """Build an inverted CDF table (with trailing adaptation counter = 0)
    from cumulative probabilities ``cum`` (ending in 32768)."""
    arr = np.asarray(cum, dtype=np.int64)
    assert arr[-1] == CDF_PROB_TOP
    out = np.zeros(len(arr) + 1, dtype=np.uint16)
    out[: len(arr)] = (CDF_PROB_TOP - arr).astype(np.uint16)
    return out


def uniform_icdf(nsymbs: int) -> np.ndarray:
    """Evenly split icdf over ``nsymbs`` symbols (last slot = counter)."""
    cum = [((i + 1) * CDF_PROB_TOP) // nsymbs for i in range(nsymbs)]
    cum[-1] = CDF_PROB_TOP
    return icdf(cum)


def update_cdf(cdf: np.ndarray, val: int, nsymbs: int) -> None:
    """Adapt an inverted CDF toward symbol ``val`` in place.

    ``cdf`` has ``nsymbs + 1`` entries; the final entry is the update
    counter.  Matches the normative adaptation rule (AV1 spec 8.4.1 /
    reference ``prob.h:110``): rate = 4 + (count >> 4) + (nsymbs > 3).
    """
    count = int(cdf[nsymbs])
    rate = 4 + (count >> 4) + (3 < nsymbs)
    # Inverted-CDF form of the spec rule: entries before `val` move toward
    # CDF_PROB_TOP, entries at/after `val` decay toward 0.
    for i in range(nsymbs - 1):
        c = int(cdf[i])
        if i < val:
            cdf[i] = c + ((CDF_PROB_TOP - c) >> rate)
        else:
            cdf[i] = c - (c >> rate)
    cdf[nsymbs] = count + (count < 32)


class RangeEncoder:
    """Bitwise-renormalizing range encoder producing AV1-conformant tile
    bytestreams.

    State: ``low`` is a 64-bit accumulation window whose top holds finished
    bits; ``rng`` is the 16-bit active range in [2^15, 2^16); ``cnt`` is the
    number of finished bits currently parked in ``low`` minus 9 (the 9-bit
    headroom covers one byte plus a carry bit before the first flush).
    """

    def __init__(self) -> None:
        self.low = 0  # 64-bit window (python int, masked on flush)
        self.rng = 0x8000
        self.cnt = -9
        self.buf = bytearray()

    # -- output helpers ---------------------------------------------------

    def _carry_into(self, pos: int) -> None:
        """Propagate +1 into already-emitted bytes ending at index ``pos``."""
        while True:
            assert pos >= 0, "carry out of buffer start"
            s = self.buf[pos] + 1
            self.buf[pos] = s & 0xFF
            if s < 0x100:
                return
            pos -= 1

    def _renorm(self, low: int, rng: int) -> None:
        # d = leading-zero count of rng as a 16-bit value
        d = 16 - rng.bit_length()
        s = self.cnt + d
        if s >= 40:
            # Flush whole bytes out of the window so low never overflows
            # 64 bits.  nready*8 data bits + 1 carry bit leave the window.
            nready = (s >> 3) + 1
            c = self.cnt + 24 - (nready << 3)
            out = low >> c
            low &= (1 << c) - 1
            carry = out >> (nready << 3)
            out &= (1 << (nready << 3)) - 1
            pos = len(self.buf)
            self.buf += int(out).to_bytes(nready, "big")
            if carry:
                self._carry_into(pos - 1)
            s = c + d - 24
        self.low = (low << d) & 0xFFFFFFFFFFFFFFFF
        self.rng = rng << d
        self.cnt = s

    # -- symbol coding ----------------------------------------------------

    def encode_q15(self, fl: int, fh: int, s: int, nsymbs: int) -> None:
        """Encode symbol ``s`` whose interval is [icdf fl, icdf fh)."""
        low = self.low
        r = self.rng
        n = nsymbs - 1
        assert 32768 <= r
        assert fh <= fl <= 32768
        if fl < CDF_PROB_TOP:
            u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s - 1))
            v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - s)
            low += r - u
            r = u - v
        else:
            r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                 EC_MIN_PROB * (n - s)
        self._renorm(low, r)

    def encode_symbol(self, s: int, cdf: np.ndarray, nsymbs: int) -> None:
        """Encode ``s`` against inverted CDF ``cdf`` (non-adaptive)."""
        fl = int(cdf[s - 1]) if s > 0 else CDF_PROB_TOP
        self.encode_q15(fl, int(cdf[s]), s, nsymbs)

    def encode_symbol_adapt(self, s: int, cdf: np.ndarray, nsymbs: int) -> None:
        self.encode_symbol(s, cdf, nsymbs)
        update_cdf(cdf, s, nsymbs)

    def encode_bool_q15(self, val: int, f: int) -> None:
        """Encode one bool; ``f`` is the Q15 split (interval size of val==1)."""
        assert 0 < f < 32768
        low = self.low
        r = self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            low += r - v
            r = v
        else:
            r -= v
        self._renorm(low, r)

    def encode_bit(self, bit: int) -> None:
        """Equiprobable raw bit inside the arithmetic stream
        (``aom_write_bit`` semantics: prob 128/256)."""
        self.encode_bool_q15(bit, (0x7FFFFF - (128 << 15) + 128) >> 8)

    def encode_literal(self, data: int, bits: int) -> None:
        for b in range(bits - 1, -1, -1):
            self.encode_bit((data >> b) & 1)

    # -- finalization -------------------------------------------------------

    def tell_bits(self) -> int:
        """Upper bound on bits used so far (monotone; +1 termination bit)."""
        return self.cnt + 10 + 8 * len(self.buf)

    def done(self) -> bytes:
        """Terminate the stream, emitting the minimal disambiguating bits."""
        low = self.low
        c = self.cnt
        # Choose the final code value: round low up to a multiple of 2^14
        # and set bit 14, guaranteeing it falls inside [low, low + rng).
        m = 0x3FFF
        e = ((low + m) & ~m) | (m + 1)
        s = c + 10  # bits still to emit (includes 1 termination bit)
        while s > 0:
            val = (e >> (c + 16)) & 0x1FF  # 8 data bits + 1 carry bit
            pos = len(self.buf)
            self.buf.append(val & 0xFF)
            if val & 0x100:
                self._carry_into(pos - 1)
            e &= (1 << (c + 16)) - 1
            s -= 8
            c -= 8
        return bytes(self.buf)


class RangeDecoder:
    """Matching range decoder (32-bit window, ``od_ec_dec`` semantics)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.end = len(data)
        self.dif = (1 << (DEC_WIN_BITS - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.tell_offs = 10 - (DEC_WIN_BITS - 8)
        self._refill()

    def _refill(self) -> None:
        s = DEC_WIN_BITS - 9 - (self.cnt + 15)
        while s >= 0 and self.pos < self.end:
            self.dif ^= self.data[self.pos] << s
            self.cnt += 8
            self.pos += 1
            s -= 8
        if self.pos >= self.end:
            self.tell_offs += _LOTS_OF_BITS - self.cnt
            self.cnt = _LOTS_OF_BITS

    def _renorm(self, dif: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & ((1 << DEC_WIN_BITS) - 1)
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, cdf: np.ndarray, nsymbs: int) -> int:
        dif = self.dif
        r = self.rng
        n = nsymbs - 1
        assert (dif >> (DEC_WIN_BITS - 16)) < r
        assert 32768 <= r
        c = dif >> (DEC_WIN_BITS - 16)
        v = r
        ret = -1
        while True:
            u = v
            ret += 1
            v = ((r >> 8) * (int(cdf[ret]) >> EC_PROB_SHIFT) >>
                 (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        r = u - v
        dif -= v << (DEC_WIN_BITS - 16)
        self._renorm(dif, r)
        return ret

    allow_update_cdf = True   # aom_reader.allow_update_cdf

    def decode_symbol_adapt(self, cdf: np.ndarray, nsymbs: int) -> int:
        ret = self.decode_symbol(cdf, nsymbs)
        if self.allow_update_cdf:
            update_cdf(cdf, ret, nsymbs)
        return ret

    def decode_bool_q15(self, f: int) -> int:
        dif = self.dif
        r = self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (DEC_WIN_BITS - 16)
        if dif >= vw:
            self._renorm(dif - vw, r - v)
            return 0
        self._renorm(dif, v)
        return 1

    def decode_bit(self) -> int:
        return self.decode_bool_q15((0x7FFFFF - (128 << 15) + 128) >> 8)

    def tell(self) -> int:
        """od_ec_dec_tell: whole bits consumed so far."""
        return self.pos * 8 - self.cnt + self.tell_offs

    def tell_frac(self) -> int:
        """od_ec_dec_tell_frac: bits consumed in 1/8-bit units
        (entcode.c od_ec_tell_frac, OD_BITRES=3)."""
        nbits = self.tell() << 3
        rng = self.rng
        lv = 0
        for _ in range(3):
            rng = (rng * rng) >> 15
            b = rng >> 16
            lv = (lv << 1) | b
            rng >>= b
        return nbits - lv

    def decode_literal(self, bits: int) -> int:
        out = 0
        for b in range(bits - 1, -1, -1):
            out |= self.decode_bit() << b
        return out

    def tell_bits(self) -> int:
        return self.pos * 8 - self.cnt + self.tell_offs
