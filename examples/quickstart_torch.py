"""Quickstart of the PyTorch port: federated GaLore fine-tuning.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The JAX quickstart (``examples/quickstart.py``) in ``repro_torch``: a
reduced qwen1.5 backbone, a synthetic classification task split across 4
non-IID clients (Dirichlet α=0.5), and 5 FedGaLore rounds — GaLoreAdamW
clients, FedAvg aggregation, AJIVE second-moment sync. The weights come
from a torch generator seeded with ``--seed``, so the numbers are not the
JAX quickstart's, only its trend.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_variant(get_config("qwen1.5-0.5b"))
    params = M.init_params(cfg, seed=args.seed, device=device)
    task = seq_classification(n_examples=1024, n_classes=4, seq_len=16,
                              vocab=cfg.vocab_size)
    clients = FederatedBatcher(task, n_clients=4, batch_size=8, alpha=0.5)
    engine = FedEngine(
        FedConfig(method="fedgalore", rank=4, lr=3e-3, local_steps=4),
        loss_fn=lambda p, b: M.loss_fn(p, cfg, b), params=params,
        target_fn=galore_target_fn(cfg))

    eval_b = clients.eval_batch(256)
    tokens = torch.as_tensor(eval_b["tokens"], device=device)
    labels = torch.as_tensor(eval_b["labels"][:, -1], device=device)
    history = []
    for rnd in range(args.rounds):
        metrics = engine.run_round(clients.round_batches(4))
        with torch.no_grad():
            logits, _ = M.forward(engine.global_params(), cfg, tokens)
        acc = float((logits[:, -1].argmax(-1) == labels).float().mean())
        print(f"round {rnd}: local_loss={metrics['mean_final_loss']:.3f} "
              f"val_acc={acc:.3f}", flush=True)
        history.append({"local_loss": metrics["mean_final_loss"],
                        "val_acc": acc})
    return history


if __name__ == "__main__":
    main()
