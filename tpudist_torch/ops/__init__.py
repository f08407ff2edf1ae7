"""Attention operators: the plain PyTorch paths and the Hopper kernels
(``ops.cuda``)."""
