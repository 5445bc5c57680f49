"""cogaps_tpu_torch — CoGAPS on PyTorch and CUDA.

The PyTorch port of cogaps_tpu (the JAX package beside it, which stays
the reference): atomic-prior Gibbs-sampled NMF ``D ~ A @ P.T`` with
per-element uncertainty and two-phase annealed MCMC. It holds the dense
and the sparse model: ``CoGAPS()`` (sparse_optimization=True or COO
input runs sparse_engine.py), the multi-chain engines, and the atlas
engine (``parallel.atlas_engine.run_atlas``), the distributed
subset-and-consensus runs ``scCoGAPS()`` and ``GWCoGAPS()``
(parallel/distributed.py) and checkpoints (utils/checkpoint.py), with
the kernels written in CUDA for Hopper (csrc/); the command line
(``python -m cogaps_tpu_torch``), h5/h5ad/10x input (io/h5.py), the native
parser (io/native.py), the result files and the analysis toolkit
(analysis.py, plots.py). It imports torch and numpy only; h5py, scipy and
matplotlib are imported inside the functions that need them.

Float32 matrix products stay in full float32: the Y tables are formed
as ((D - M O^T) * invS2) @ O with heavy cancellation, which TF32's ~3
digits would corrupt.
"""

import torch

from . import analysis, plots
from .api import CoGAPS, GWCoGAPS, scCoGAPS
from .params import CogapsParams
from .result import CogapsResult
from .utils.logging import build_report

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["CoGAPS", "scCoGAPS", "GWCoGAPS", "CogapsParams", "CogapsResult",
           "analysis", "plots", "build_report", "__version__"]
