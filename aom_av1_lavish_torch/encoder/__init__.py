"""Encoders: the GOP encoder (gop.py), the wavefront KEY encoder
(tpu_intra.py) and the host encoder classes they build on, counterparts
of the modules of the same names in aom_av1_lavish_tpu/encoder."""

from .encoder import (encode_lossless_ivf, LosslessEncoder,  # noqa: F401
                      make_sequence_header, make_lossless_frame_header)
