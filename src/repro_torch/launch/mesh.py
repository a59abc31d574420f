"""The host mesh (port of ``repro/launch/mesh.py::make_host_mesh``).

``make_host_mesh`` returns a ``torch.distributed.device_mesh.DeviceMesh``
with axes ``("data", "model")`` over the process group's world. A single
process with no process group gets one of world size 1 on an in-memory
``HashStore``: no socket, no environment variables. Under a launcher
(``torchrun``) the existing group's world is used. The production meshes
(16 × 16, 2 × 16 × 16) belong to the dry-run, which is not ported yet
(ROADMAP Queue 1 item 12b).
"""
from __future__ import annotations

import torch

from .. import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_host_mesh(model_parallel: int = 1, device="cuda"):
    """A (world // model_parallel, model_parallel) ``("data", "model")``
    mesh of ``device``'s type over the process group's world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world size {n}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
