"""Cohorts from a large population, in the PyTorch port: a 10⁴-client
virtual population with faults.

    PYTHONPATH=src python examples/population_cohorts_torch.py            # the card
    PYTHONPATH=src python examples/population_cohorts_torch.py --device cpu

The JAX example (``examples/population_cohorts.py``) in ``repro_torch``.
Each round samples an 8-client cohort out of a 10,000-client population
(Dirichlet α=0.5 shards), injects dropout and straggler faults, and runs
the masked FedGaLore round. Straggler contributions land 1–2 rounds
stale through the FedBuff-style buffer; every client's rank-r factored
state (accumulator R_i + projected moments ṽ_i) sticks in a
spill-to-disk store whose resident window is 8 shards of 512 clients —
everything colder lives on disk through the crash-safe checkpoint
writer. The drift record prints the projected-moment divergence 𝒮 is
absorbing each round. The weights come from a torch generator seeded
with ``--seed``, so the numbers are not the JAX example's.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.core.population import ParticipationConfig, PopulationRunner
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as M

POPULATION = 10_000
COHORT = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    params = M.init_params(cfg, seed=args.seed, device=device)
    task = seq_classification(n_examples=2048, n_classes=4, seq_len=16,
                              vocab=cfg.vocab_size)
    batcher = FederatedBatcher(task, n_clients=POPULATION, batch_size=8,
                               alpha=0.5)
    pcfg = ParticipationConfig(population=POPULATION, dropout_rate=0.25,
                               straggler_rate=0.25, max_staleness=2,
                               staleness_decay=0.5, seed=17)
    engine = FedEngine(
        FedConfig(method="fedgalore", rank=4, lr=3e-3, local_steps=4,
                  participation=pcfg),
        loss_fn=lambda p, b: M.loss_fn(p, cfg, b), params=params,
        target_fn=galore_target_fn(cfg))

    def batches_for(ids, _round):
        return batcher.round_batches(4, clients=[int(i) for i in ids])

    eval_b = batcher.eval_batch(256)
    tokens = torch.as_tensor(eval_b["tokens"], device=device)
    labels = torch.as_tensor(eval_b["labels"][:, -1], device=device)
    history = []
    with tempfile.TemporaryDirectory(prefix="population_store_") as store:
        runner = PopulationRunner(engine, batches_for, cohort=COHORT,
                                  pcfg=pcfg, store_dir=store, shard_size=512,
                                  max_resident_shards=8)
        for rnd in range(args.rounds):
            rec = runner.run_round()
            with torch.no_grad():
                logits, _ = M.forward(engine.global_params(), cfg, tokens)
            acc = float((logits[:, -1].argmax(-1) == labels).float().mean())
            print(f"round {rnd}: cohort={rec['plan'].clients.tolist()} "
                  f"on-time={rec['participants']} dropped={rec['dropped']} "
                  f"straggling={rec['straggling']} "
                  f"buffered={rec['buffered']} "
                  f"stale_merged={rec['stale_merged']} "
                  f"drift={rec['moment_divergence']:.3f} "
                  f"loss={rec['mean_final_loss']:.3f} val_acc={acc:.3f}",
                  flush=True)
            history.append(dict(runner.history[-1], val_acc=acc))
        runner.store.flush()
        print(f"store: {runner.store.n_shards} shards of "
              f"{runner.store.shard_size} clients, "
              f"{runner.store.resident_bytes() / 2**20:.1f} MiB resident, "
              f"{runner.store.spills} spills / {runner.store.loads} loads")
    assert all(np.isfinite(h["mean_final_loss"]) for h in history)
    return history


if __name__ == "__main__":
    main()
