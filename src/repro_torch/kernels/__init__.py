"""The port's kernels: hand-written CUDA for sm_90a behind ``ops``, with
their plain PyTorch versions in ``ref``.

* ``lowrank_linear`` — batched heterogeneous-adapter low-rank apply (the
  serving projection read), ``csrc/lowrank_linear_batched.cu``.
"""
