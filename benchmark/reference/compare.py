"""The comparison that decides `correct`, and the quality it reads.

The reference is a frozen copy of the port's own AV1 decoder (`av1/`:
its `decoder/`, `bitstream/` and `common/`, plain NumPy, with no native
fast path; one change since, the inverse transform's stages as vector
steps, equal to the sample).  It takes nothing the encoder made except
the stream it judges.  For a stream the window wrote it decodes the
first `n_coded` coded frames (hidden ones, such as an ARF, included) and
holds each against the encoder's own reconstruction of that frame,
sample by sample: an AV1 encoder's reconstruction is, by the standard,
what every conforming decoder rebuilds from its stream, so any
difference is drift (a prediction, a residual, a filter or a symbol that
the stream does not say).  A frame the reference cannot decode, or that
the encoder never reconstructed, counts all its samples as different.

The encoder is built on the same `bitstream/` and `common/` modules
(headers, tables, transforms, quantizer, prediction, motion-vector
references, loop filter), so a fault in one of those shows on both sides
and reads no difference; what makes this decoder a second witness for
them is the repository's conformance against stock aomdec
(tests/test_decode_oracle.py, tests/test_conformance_corpus.py), which
runs only where an aomenc/aomdec build is present.

The shown frames it decodes are also held against the source for the Y
PSNR the benchmark reports (a frozen copy of the port's
bench_torch.psnr_y arithmetic: the mean of the frames' MSE, 99 dB when
lossless).
"""

from __future__ import annotations

import numpy as np

from .av1.bitstream.ivf import read_ivf
from .av1.decoder.decoder import decode_frame_obus


def psnr_y(dec_frames, src_frames) -> float:
    """Y PSNR over the frames: 99 when lossless."""
    mse = np.mean([np.mean((np.asarray(d[0], np.float64)
                            - np.asarray(s[0], np.float64)) ** 2)
                   for d, s in zip(dec_frames, src_frames)])
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def _crop(planes, w, h):
    return (planes[0][:h, :w], planes[1][:h // 2, :w // 2],
            planes[2][:h // 2, :w // 2])


def decode_prefix(path: str, n_coded: int):
    """The first n_coded coded frames of the IVF stream at `path`, in
    coding order, and the shown frames decoded up to there -> (coded,
    shown, error): error is the reference's message where it stopped on
    a frame it could not decode, else None."""
    coded, shown = [], []
    state = {"slots": [None] * 8,
             "inspect_hook": lambda dec, fh, out: coded.append(out)}
    sh = None
    try:
        for payload, _pts in read_ivf(path):
            frames, sh = decode_frame_obus(payload, sh, state)
            shown.extend(frames)
            if len(coded) >= n_coded:
                break
    except Exception as e:  # noqa: BLE001 - any failure is "undecodable"
        return coded[:n_coded], shown, f"{type(e).__name__}: {e}"[:300]
    return coded[:n_coded], shown, None


def check_stream(path: str, n_coded: int, recon, sources, w: int, h: int):
    """Decode the first n_coded coded frames of the stream at `path` and
    hold them against `recon`, the encoder's reconstruction of each coded
    frame in coding order, and the shown ones against `sources` (display
    order) -> dict: mismatch_samples (samples of those frames where the
    two differ, a frame missing on either side counting whole),
    coded_decoded, shown (decoded shown frames), psnr_y_db over them (None
    when none was shown), error (where the reference stopped, or None)."""
    coded, shown, error = decode_prefix(path, n_coded)
    per_frame = w * h + 2 * (w // 2) * (h // 2)
    mismatch = 0
    for i in range(n_coded):
        if i >= len(coded) or i >= len(recon) or recon[i] is None:
            mismatch += per_frame
            continue
        for a, b in zip(_crop(coded[i], w, h), _crop(recon[i], w, h)):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                mismatch += a.size
            else:
                mismatch += int(np.count_nonzero(a != b))
    shown = [_crop(f, w, h) for f in shown[:len(sources)]]
    return {"mismatch_samples": mismatch, "coded_decoded": len(coded),
            "shown": len(shown),
            "psnr_y_db": psnr_y(shown, sources) if shown else None,
            "error": error}
