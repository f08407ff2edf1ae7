"""tpudist_torch: the PyTorch/CUDA port of tpudist.

The JAX package ``tpudist`` stays the reference; each module here mirrors
the module of the same path there and is held against it by the CPU
parity tests (``tests/test_torch_*.py``). This package imports torch,
numpy and the standard library only, never ``jax`` or ``tpudist``: what it
needs from the JAX package's standard-library modules it keeps as its own
copy.
"""

__version__ = "0.1.0"
