"""recsys_examples_torch — the PyTorch / CUDA (H100) port of recsys_examples_tpu.

Module paths mirror the JAX package: each module here has its counterpart at
the same path under `recsys_examples_tpu/`. The port imports torch only,
never jax, flax or the JAX package. Entry points take `device=` and default
to CUDA; they raise when no card is present unless the caller asks for the
CPU.
"""

__version__ = "0.1.0"
