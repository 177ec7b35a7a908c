"""PyTorch/CUDA port of neuralnetworklibrary_tpu for NVIDIA Hopper GPUs.

The port grows slice by slice beside the JAX package, which stays the
reference.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel under ``csrc/``, built at first
use by ``kernels.build``.  The port never imports JAX or the JAX package.
"""
