"""sdr_tpu_torch — the FM broadcast receiver ported to PyTorch and CUDA.

The port of `sdr_tpu` (the JAX reference, which stays as it is) to one
NVIDIA Hopper card.  Plain tensor code is PyTorch; every Pallas kernel of
the reference becomes a kernel written by hand for sm_90a under `csrc/`.
This package never imports jax or sdr_tpu: the GPU machine has neither.
The module layout mirrors sdr_tpu, so each module's counterpart sits at
the same relative path.

Numerics: cuDNN runs float32 convolutions in TF32 by default, which keeps
about three decimal digits and would make the exact profiles (the f32
default, `int8x2`) drift from the reference.  Importing the package turns
TF32 off for convolutions and matrix products in this process.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from sdr_tpu_torch.config import MODES, ModeConfig, get_mode  # noqa: E402
from sdr_tpu_torch.models.receiver import Receiver  # noqa: E402

__version__ = "0.1.0"

__all__ = ["MODES", "ModeConfig", "get_mode", "Receiver", "__version__"]
