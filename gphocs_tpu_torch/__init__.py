"""gphocs_tpu_torch — the G-PhoCS sampler of gphocs_tpu, ported to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package gphocs_tpu is the reference: this package keeps its module
names and its state layout, and its tests hold each module against the JAX
counterpart.  It never imports jax.
"""

__version__ = "0.1.0"

from gphocs_tpu_torch.constants import OLDAGE  # noqa: F401,E402
