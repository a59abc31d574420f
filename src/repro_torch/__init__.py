"""PyTorch port of the ``repro`` package for one NVIDIA H100.

The port mirrors the JAX module tree (``repro_torch.models.layers`` ↔
``repro.models.layers``) and imports neither ``jax`` nor ``repro``. Entry
points run on the card unless the caller asks for the CPU
(``device="cpu"``); on a CUDA tensor every kernel wrapper launches its
hand-written kernel or raises, and on a CPU tensor it runs the kernel's
plain PyTorch version.

Slice 1: multi-tenant serving of the dense family (``launch.serve``) with
the batched heterogeneous-adapter kernel. Slice 2: the FedGaLore round
(``core.fed.FedEngine`` for the GaLore methods) with the lift-free
low-rank apply, the fused GaLore step and the batched Jacobi eigensolver.
Later slices serve rwkv6-1.6b and starcoder2-7b, put flash attention on
every dense prefill, and run every method of the paper's Table 1 — the
LoRA baselines and FedAvg beside the GaLore methods — in
``core.fed.FedEngine``. Every kernel is CUDA C++ for sm_90a
(``kernels/csrc``).
"""
import torch


def resolve_device(device) -> torch.device:
    """The entry points' device check: ``"cuda"`` without a card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Fence before a host clock read: waits for the card's queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
