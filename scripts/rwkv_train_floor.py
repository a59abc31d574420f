"""How far rounding alone moves rwkv6-1.6b's training rounds, on one CUDA card.

  python3 scripts/rwkv_train_floor.py [--lr 3e-3 3e-4 1e-4] [--seed 0]

For each learning rate, runs ``chip_smoke.py``'s rwkv6 training phase's
two FedGaLore rounds (full width, bf16, C = 4, T = 2, batch 4 x 128, rank
8) as that phase reads them (``chip_smoke.rwkv_parity_readings``: every
kernel, every plain version, every kernel with 1 % of the embedding table
one bf16 ulp up, and round 0 with the preconditioner in float64); then
round 0 through the kernels and round 1 through the plain versions,
which gives round 1 one start ("delta_round1", whether round 0 repeats
bit for bit, the loss and 𝒮 readings of round 1 from that start); then
the plain versions with half the entries of ``lowrank_linear``'s and
``galore_precond_step``'s outputs one unit in the last place off (what
another summation order does there), in both rounds and in round 1
alone after the kernels' round 0. Prints one JSON line a learning rate:
the readings, those of the rounding-noise runs (per-step loss
differences and D, the Frobenius distance of the rounds' change of the
target leaves over the plain run's; round 1's alone over the kernel
run's) under ``controls.rounding_noise``. These are the readings the
phase's learning rate and gates were chosen from.
Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def rounding_noise(gen, share=0.5):
    """A function giving a context in which the round's rounded kernels'
    plain versions (``ops.lowrank_linear`` and ``ops.galore_precond_step``)
    have a ``share`` of their output entries moved one unit in the last
    place of their type, up or down at random (from ``gen``). Gradients
    pass through unchanged."""
    from repro_torch.kernels import ops

    def moved(t):
        x = t.detach()
        up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        to = torch.where(up, float("inf"), float("-inf")).to(x.dtype)
        pick = torch.rand(x.shape, generator=gen, device=x.device) < share
        return t + torch.where(pick, torch.nextafter(x, to) - x, 0)

    @contextlib.contextmanager
    def ctx():
        orig = {n: getattr(ops, n) for n in ("lowrank_linear",
                                             "galore_precond_step")}

        def lowrank(*a, **kw):
            return moved(orig["lowrank_linear"](*a, **kw))

        def precond(*a, **kw):
            u, m, v = orig["galore_precond_step"](*a, **kw)
            return moved(u), m, v

        ops.lowrank_linear, ops.galore_precond_step = lowrank, precond
        try:
            with ops.plain_kernels():
                yield
        finally:
            ops.lowrank_linear = orig["lowrank_linear"]
            ops.galore_precond_step = orig["galore_precond_step"]

    return ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[3e-3, 3e-4, 1e-4])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rwkv_train_floor: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    for lr in args.lr:
        _, rl, _, plain, readings = cs.rwkv_parity_readings(args.seed, lr)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + 7)
        noise = rounding_noise(gen)
        noisy = cs._rwkv_rounds(args.seed, lr, modes=(noise,) * 2)
        late = cs._rwkv_rounds(args.seed, lr, modes=("kernel", noise))
        mixed = cs._rwkv_rounds(args.seed, lr, modes=("kernel", "plain"))
        init, start = plain.snaps[0], rl.snaps[1]
        readings.update(
            round1_start_bit_identical=all(
                torch.equal(a, b) for a, b in zip(mixed.snaps[1], start)),
            delta_round1=cs._change_rel(rl.snaps[2], mixed.snaps[2],
                                        start)[0],
            loss_round1=(rl.rounds[1]["losses"]
                         - mixed.rounds[1]["losses"]).abs().max().item(),
            sync_round1_same_start=cs._tree_rel(rl.synced[1],
                                                mixed.synced[1]))
        readings["controls"]["round1_lost"] = cs._change_rel(
            start, mixed.snaps[2], start)[0]
        readings["controls"]["rounding_noise"] = {
            "loss": cs._loss_diff(noisy, plain),
            "delta": cs._change_rel(noisy.snaps[-1], plain.snaps[-1],
                                    init)[0],
            "delta_round0": cs._change_rel(noisy.snaps[1], plain.snaps[1],
                                           init)[0],
            "delta_round1": cs._change_rel(late.snaps[2], rl.snaps[2],
                                           start)[0]}
        print(json.dumps({**readings, "seed": args.seed, "card": card}),
              flush=True)
        del rl, plain, noisy, late, mixed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
