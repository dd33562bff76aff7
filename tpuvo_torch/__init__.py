"""tpuvo_torch — the PyTorch/CUDA port of tpuvo.

Mirrors ``tpuvo/``'s layout and names module for module; the JAX package
stays the reference the port is tested against.  Plain tensor code is
PyTorch; each Pallas kernel of the JAX package is a hand-written CUDA
kernel under ``csrc/`` (built at first use, see ``ops/cuda/build.py``).

Design rules:
  * functions on tensors; ``NamedTuple`` state; the device is an explicit
    argument and randomness an explicit ``torch.Generator``;
  * fp32 throughout — TF32 and bf16 are off (geometry is precision-critical:
    low-precision matmuls took ATE on the bundled sequence from 0.195 to 3.2);
  * this package never imports JAX.
"""

import torch as _torch

# Twin of tpuvo/__init__.py's "highest" matmul precision: no TF32 anywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from tpuvo_torch.config import EngineConfig, MatcherConfig, PICPConfig, RansacConfig

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "MatcherConfig",
    "PICPConfig",
    "RansacConfig",
    "__version__",
]
