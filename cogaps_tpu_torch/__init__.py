"""cogaps_tpu_torch — CoGAPS on PyTorch and CUDA.

The PyTorch port of cogaps_tpu (the JAX package beside it, which stays
the reference): atomic-prior Gibbs-sampled NMF ``D ~ A @ P.T`` with
per-element uncertainty and two-phase annealed MCMC. This slice holds
the dense model's main path: ``CoGAPS()`` and the multi-chain engine,
with the sweep kernel written in CUDA for Hopper (csrc/sweep.cu). It
imports torch and numpy only.

Float32 matrix products stay in full float32: the Y tables are formed
as ((D - M O^T) * invS2) @ O with heavy cancellation, which TF32's ~3
digits would corrupt.
"""

import torch

from .api import CoGAPS
from .params import CogapsParams
from .result import CogapsResult

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["CoGAPS", "CogapsParams", "CogapsResult", "__version__"]
