"""PyTorch/CUDA port of the DeFT training system.

A second package beside the JAX reference (``src/repro``): the same
planner (copied, numpy only), the same parameter tree and bucket layouts,
and an eager PyTorch executor whose TPU kernels are replaced by CUDA
kernels written by hand for Hopper (``kernels/``).  Public functions keep
the JAX package's layouts ([B, S, H, D] attention, stacked layer params)
so the parity tests compare like with like.

Importing this package (or any module in it) builds nothing and touches
no device; kernels compile at first use on a CUDA tensor.
"""
