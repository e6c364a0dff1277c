"""videotuna-tpu on PyTorch and CUDA.

A second package beside the JAX one (``videotuna_tpu``), which stays the
reference: same configs, same parameter trees (through
``tools/from_jax.py``), same inputs and noise give the same outputs within a
stated tolerance.  Module names mirror ``videotuna_tpu`` one for one.  The
package imports torch, numpy and the standard library only; every TPU kernel
it needs is a kernel written by hand for Hopper under ``kernels/csrc``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise when no GPU is present and the CPU was not asked for.
"""

__version__ = "0.1.0"
