"""The SE(3)-equivariant stack, TFN and the SE(3)-Transformer (port of
``distegnn_tpu/models/se3``): spherical-harmonic and Wigner math in so3.py
(host numpy, float64), the run-time basis in torch (basis.py), and the conv
and attention layers as contractions over padded edge arrays (tfn.py,
attention.py). These families reach no kernel of the JAX package: they run
plain PyTorch, as the JAX package runs plain XLA."""

from distegnn_tpu_torch.models.se3.attention import (GConvSE3Partial, GMABSE3,
                                                     GSE3Res, SE3Transformer)
from distegnn_tpu_torch.models.se3.dynamics import (SE3TransformerDynamics,
                                                    TFNDynamics)
from distegnn_tpu_torch.models.se3.fibers import Fiber
from distegnn_tpu_torch.models.se3.tfn import G1x1SE3, GConvSE3, GNormSE3, TFN

__all__ = ["Fiber", "GConvSE3", "GNormSE3", "G1x1SE3", "TFN", "TFNDynamics",
           "GConvSE3Partial", "GMABSE3", "GSE3Res", "SE3Transformer",
           "SE3TransformerDynamics"]
