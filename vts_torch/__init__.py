"""vts_torch — the PyTorch/CUDA port of vts_tpu for one NVIDIA H100.

Module names mirror ``vts_tpu`` so each counterpart is easy to find.  The
package imports torch, numpy and scipy only: never jax, flax, optax or
anything of ``vts_tpu``.  Public functions take NHWC tensors, like their JAX
counterparts; the networks run on NCHW views of that same memory
(``channels_last``).  Entry points run on ``cuda`` unless the caller asks for
the CPU (``--device cpu`` / ``device="cpu"``), and raise when CUDA is asked
for but absent.

The TPU kernels of the reference are hand-written Hopper kernels here
(``vts_torch/csrc``), built at first use by :mod:`vts_torch.kernels.build`.
"""
