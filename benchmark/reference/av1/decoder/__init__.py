from .decoder import (CorruptFrameError, decode_frame_obus,  # noqa: F401
                      decode_ivf)
