"""PyTorch/CUDA port of the TOM serving stack (``src/repro`` is the JAX
reference it is tested against).

The port imports ``torch`` only. Module paths mirror ``repro``'s, so each
counterpart is found at the same place; the hand-written Hopper kernels live
under ``kernels/csrc`` and are built with ``nvcc`` at first use.
"""
