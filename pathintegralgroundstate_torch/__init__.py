"""PyTorch / CUDA port of the PIGS engine, beside the JAX reference.

`pathintegralgroundstate_tpu` is the reference; this package runs the same
Monte Carlo step (`sweep.Sweeper.step`: the unfused sweep in monoshot and
per-level bisection or staging form, and the fused composite sweep) in
PyTorch, with its kernels written by hand for Hopper (`csrc/`, bound in
`ops/kernels.py`).  `config` is the port's own copy of the reference's
configuration module.

The package imports `torch` and never `jax` or the reference package.
"""

import torch

from .config import Geometry, SimConfig, geometry, load_namelist_config

# The float32 bridge and dyadic matmuls (ops/moves.segment_regrow,
# ops/bisection._construct_levels) must not drop to TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["SimConfig", "Geometry", "geometry", "load_namelist_config"]
