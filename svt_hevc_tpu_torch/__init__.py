"""svt_hevc_tpu_torch — the PyTorch/CUDA port of svt_hevc_tpu.

The JAX package (svt_hevc_tpu) is the reference; this package runs the
same encoder on an NVIDIA H100 through PyTorch and hand-written CUDA
kernels (csrc/), and produces byte-identical streams. It imports no JAX
and nothing of the JAX package.

    from svt_hevc_tpu_torch import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=..., height=..., qp=32,
                                intra_period=-1))      # runs on "cuda"
    stream, recons = enc.encode(frames)

Encoder(cfg, device="cpu") runs the same stages with the kernels' plain
PyTorch versions.
"""

import torch as _torch

# The encoder's float32 contractions (open-loop intra search) are exact
# only in full float32: TF32 keeps ~10 mantissa bits and would change
# mode decisions, so both TF32 switches are off for the whole process.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .api import EncoderHandle, Packet  # noqa: E402
from .config import EncoderConfig  # noqa: E402
from .pipeline.encoder import Encoder  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Encoder", "EncoderConfig", "EncoderHandle", "Packet",
           "__version__"]
