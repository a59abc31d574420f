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
  ``csrc/batched_eigh.cu``;
* ``rwkv6_scan.rwkv6_scan`` — the RWKV6 WKV recurrence,
  ``csrc/rwkv6_scan.cu``;
* ``flash_attention.flash_attention`` — causal GQA attention with a
  sliding window, forward only, ``csrc/flash_attention.cu`` (its
  tensor-core route shares ``csrc/hopper_ptx.cuh`` with
  ``lowrank_tiles.cuh``).

As in the JAX package, ``kernels.rwkv6_scan`` and
``kernels.flash_attention`` name the dispatching ``ops`` functions; a
kernel module's own wrapper (with its launch counter) is reached as
``from repro_torch.kernels.rwkv6_scan import rwkv6_scan``.
"""
from .ops import flash_attention, rwkv6_scan  # noqa: F401
