"""Learning-rate schedules (port of ``repro/optim/schedule.py``; the
paper's Appendix G uses cosine with warmup). A schedule maps a host step
count to a float."""
from __future__ import annotations

import math


def constant(lr: float):
    def schedule(step):
        del step
        return float(lr)
    return schedule


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.0):
    """Linear warmup to peak_lr, cosine decay to final_frac*peak_lr."""
    warmup_steps = max(int(warmup_steps), 1)
    decay_steps = max(int(total_steps) - warmup_steps, 1)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return peak_lr * min(step / warmup_steps, 1.0)
        t = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        return peak_lr * (final_frac
                          + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))

    return schedule


def linear_warmup_frac(peak_lr: float, warmup_frac: float, total_steps: int,
                       final_frac: float = 0.0):
    """Paper-style: warmup given as a fraction of total steps (e.g. 0.06)."""
    return cosine_with_warmup(peak_lr, int(warmup_frac * total_steps),
                              total_steps, final_frac)
