"""The port's kernels: hand-written CUDA for sm_90a behind ``ops``, with
their plain PyTorch versions in ``ref``.

* ``lowrank_linear.lowrank_linear`` — the lift-free training read of one
  factored block, ``csrc/lowrank_linear.cu``;
* ``lowrank_linear.lowrank_linear_batched`` — the batched
  heterogeneous-adapter serving read, ``csrc/lowrank_linear_batched.cu``
  (both share ``csrc/lowrank_tiles.cuh``);
* ``galore_adamw.galore_precond_step`` / ``galore_adamw_step`` — the fused
  GaLore preconditioner and GaLoreAdamW step, ``csrc/galore_adamw.cu``;
* ``batched_eigh.jacobi_eigh`` — the batched small Jacobi eigensolver,
  ``csrc/batched_eigh.cu``.
"""
