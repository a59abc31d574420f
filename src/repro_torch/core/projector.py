"""GaLore ``proj_type=std`` side rule (port of ``repro/core/projector.py``:
``RIGHT``, ``LEFT``, ``proj_side``)."""
from __future__ import annotations

RIGHT = "right"
LEFT = "left"


def proj_side(shape) -> str:
    """GaLore ``proj_type=std``: right basis iff m >= n (square ⇒ right).

    Shapes may carry leading batch dims (stacked scan blocks) — only the
    trailing two matter.
    """
    if len(shape) < 2:
        raise ValueError(f"projector requires a ≥2-D block, got {shape}")
    m, n = shape[-2:]
    return RIGHT if m >= n else LEFT
