"""gligen_tpu_torch — the PyTorch/CUDA port of ``gligen_tpu``.

The same grounded text-to-image system as ``gligen_tpu`` (JAX/Flax/Pallas,
which stays the reference), for an NVIDIA Hopper card.  Each module keeps
the name of its ``gligen_tpu`` counterpart.  Public functions and modules
keep the JAX layouts (NHWC images and latents, (B, N, H*C) token rows), so
the parity tests compare like with like.

Precision policy (``gligen_tpu/inference/pipeline.py``): parameters are
fp32; each module computes in its ``dtype`` (bf16 on the card); norm
statistics and softmax run in fp32.

The package imports ``torch`` and ``numpy`` only.  Its one CUDA kernel
(``csrc/flash_fwd.cu``) is compiled by ``nvcc`` at its first launch.
"""

__version__ = "0.1.0"
