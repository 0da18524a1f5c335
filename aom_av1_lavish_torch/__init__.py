"""aom_av1_lavish_torch — the PyTorch/CUDA port of aom_av1_lavish_tpu.

A package that stands on its own: it imports torch, never jax, and
nothing of aom_av1_lavish_tpu.  The device layer of the JAX package
(batched transforms, quantizer, motion search and compensation, wavefront
intra, device-RDO intra trials, lossless analyze, deblock, the P-frame
chain, single P frames, the realtime stream and the frame-parallel GF
group) is re-implemented on torch tensors in ops/ and parallel/, with the
Pallas kernels re-written by hand for NVIDIA Hopper (ops/csrc/*.cu).  The
host layers (api, controls, apps, bitstream, common, runtime, dsp, models,
encoder, decoder, utils) are the port's own copies of the JAX package's
modules of the same names, with the seams that reached a JAX module
calling ops/ or parallel/ instead.

Entry points (api.Encoder through EncoderConfig.device, apps.enc --device,
GopEncoder, encode_gop_ivf, encode_twopass_ivf, first_pass,
TorchAllIntraEncoder, encode_tpu_ivf, TpuRdoAllIntraEncoder,
encode_tpu_rdo_ivf, TpuLowDelayEncoder, encode_tpu_lowdelay_ivf,
encode_realtime_tpu_ivf, encode_lossless_ivf, WavefrontEncoder,
IntraTrialEngine, DeviceChainEncoder, DeviceInterEncoder, DeviceRtEncoder,
parallel.sharding.make_mesh) run on the card unless the caller passes a
device; without a CUDA device they raise.  Functions below them take tensors and work on the tensors'
device.  On a CPU tensor each kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.

Every integer result must be bit-identical to the reference, so TF32 is
off for matmuls and cuDNN convolutions alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.4.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when the caller names
    one, else the card.  Without a CUDA device that is an error, never a
    quiet run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
