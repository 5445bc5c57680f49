"""cogaps_tpu_torch — CoGAPS on PyTorch and CUDA.

The PyTorch port of cogaps_tpu (the JAX package beside it, which stays
the reference): atomic-prior Gibbs-sampled NMF ``D ~ A @ P.T`` with
per-element uncertainty and two-phase annealed MCMC. It holds the dense
and the sparse model: ``CoGAPS()`` (sparse_optimization=True or COO
input runs sparse_engine.py), the multi-chain engines, and the atlas
engine (``parallel.atlas_engine.run_atlas``), the distributed
subset-and-consensus runs ``scCoGAPS()`` and ``GWCoGAPS()``
(parallel/distributed.py) and checkpoints (utils/checkpoint.py), with
the kernels written in CUDA for Hopper (csrc/). It imports torch and
numpy only.

Float32 matrix products stay in full float32: the Y tables are formed
as ((D - M O^T) * invS2) @ O with heavy cancellation, which TF32's ~3
digits would corrupt.
"""

import torch

from .api import CoGAPS, GWCoGAPS, scCoGAPS
from .params import CogapsParams
from .result import CogapsResult

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["CoGAPS", "scCoGAPS", "GWCoGAPS", "CogapsParams", "CogapsResult",
           "__version__"]
