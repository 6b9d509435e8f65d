"""tinyfusers_tpu_torch: the PyTorch + CUDA port of tinyfusers_tpu.

Same module layout and public function names as the JAX package, so each
module's counterpart is found at the same relative path. Public functions
keep the JAX layouts (NHWC activations, (B, S, H*d) packed attention,
(in, out) linear weights and HWIO conv weights at the ops level); inside,
models are ``nn.Module``s holding torch-layout parameters.

The Pallas kernels of the SD1.5 text-to-image path are hand-written CUDA
kernels for Hopper (``csrc/``), built on first use by ``kernels/_build``.
Entry points run on the GPU unless the caller asks for the CPU; the
package never imports jax or tinyfusers_tpu.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
