"""roar_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of roar_tpu.

The package mirrors roar_tpu's file layout, so each module names its JAX
counterpart.  It imports torch and never jax, flax or optax, and nothing from
roar_tpu.  Kernels live under `kernels/` with their CUDA sources in `csrc/`,
built on first use into `build/`.
"""
