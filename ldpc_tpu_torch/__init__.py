"""PyTorch + CUDA port of the ldpc_tpu Monte-Carlo LDPC simulator.

The JAX package ``ldpc_tpu`` stays the reference; this package imports
nothing from it. Its entry points run on the card unless the caller passes
``device="cpu"``, where the plain PyTorch versions of the kernels run.
"""
