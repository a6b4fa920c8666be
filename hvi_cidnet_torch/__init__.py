"""HVI-CIDNet in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of ``hvi_cidnet_tpu`` (JAX on TPU, kept as the reference): it
imports ``torch`` and never ``jax`` or ``hvi_cidnet_tpu``. Module names
mirror the JAX package; a JAX ``X_pallas.py`` is an ``X_cuda.py`` here.
"""

from hvi_cidnet_torch.models.cidnet import (  # noqa: F401
    CIDNet,
    CIDNetConfig,
    HVIGates,
    cast_conv_weights,
    cidnet_forward,
)
from hvi_cidnet_torch.serve import Enhancer  # noqa: F401
