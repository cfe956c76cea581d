"""crypto12381_tpu_torch: the BLS12-381 pairing framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `crypto12381_tpu` that imports nothing from it.
Operations run where their tensors are: a CUDA tensor launches the CUDA
kernel, a CPU tensor runs the kernel's plain PyTorch version.

    from crypto12381_tpu_torch import pair_batch
    gt = pair_batch(g1_points, g2_points)            # on the CUDA card
    gt = pair_batch(g1_points, g2_points, device="cpu")
"""

from ._build import LAUNCHES, reset_launches
from .pairing.pairing import pair_batch, pairing_affine

__all__ = ["LAUNCHES", "pair_batch", "pairing_affine", "reset_launches"]
