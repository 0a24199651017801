"""distegnn_tpu_torch — the PyTorch + CUDA port of distegnn_tpu.

The JAX package ``distegnn_tpu`` stays the reference. This package mirrors its
module paths (``ops/``, ``models/``, ``serve/``, ``parallel/``) so each
counterpart is easy to find, imports ``torch``, numpy and yaml only, and never
imports ``jax``, ``flax`` or anything under ``distegnn_tpu``.

Every Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes``. On CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

import torch

# f32 matmuls and convolutions run in full f32, never TF32: the port's f32
# path is held against JAX at "highest" matmul precision, and TF32 keeps only
# ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry-point device policy: default to CUDA and refuse to fall back.

    ``None`` means ``"cuda"``; a CUDA device without an available card raises
    instead of silently running on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels (what the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "distegnn_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path explicitly")
    return dev
