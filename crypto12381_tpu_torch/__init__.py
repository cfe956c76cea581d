"""crypto12381_tpu_torch: the BLS12-381 pairing framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `crypto12381_tpu` that imports nothing from it.
Operations run where their tensors are: a CUDA tensor launches the CUDA
kernel, a CPU tensor runs the kernel's plain PyTorch version.

    from crypto12381_tpu_torch import G1Vec, ZpVec, pair_batch
    gt = pair_batch(g1_points, g2_points)            # on the CUDA card
    gt = pair_batch(g1_points, g2_points, device="cpu")
    pts = G1Vec.generator((n,)) ** ZpVec.from_ints(scalars)   # GLV ladder
    acc = pts.msm(ZpVec.from_ints(more_scalars))              # Pippenger
"""

from ._build import LAUNCH_EXPONENTS, LAUNCH_ROWS, LAUNCHES, reset_launches
from .api.batch import G1Vec, ZpVec
from .msm.pippenger import msm_g1
from .pairing.pairing import pair_batch, pairing_affine

__all__ = ["LAUNCHES", "LAUNCH_EXPONENTS", "LAUNCH_ROWS", "G1Vec", "ZpVec", "msm_g1",
           "pair_batch", "pairing_affine", "reset_launches"]
