"""Hand-written Hopper kernels (counterpart of ``tpudist.ops.pallas``).
Sources live in ``tpudist_torch/csrc/``; nothing is built at import."""
