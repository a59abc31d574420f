"""End-to-end example of the PyTorch port: federated fine-tuning of a
~125M-parameter backbone (paper-roberta-like: 12L, d=768 — RoBERTa-base
scale, the paper's NLU setting) for a few hundred local steps in all,
comparing FedGaLore against a federated-LoRA baseline under non-IID data.

    PYTHONPATH=src python examples/federated_finetune_100m_torch.py \\
        [--rounds 50] [--method fedgalore] [--alpha 0.5] [--device cpu]

``examples/federated_finetune_100m.py`` in ``repro_torch``, on the card
unless ``--device cpu``. Reduce --rounds for a quick run; 50 rounds × 4
local steps = 200 optimizer steps per client stream. The weights come
from a torch generator seeded with 0, so the numbers are not the JAX
example's, only its trend. ``main`` returns the JSON rows it printed and
the engine.
"""
import argparse
import json
import time

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--method", default="fedgalore")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("paper-roberta-like")   # 12L d=768 — ~125M params
    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.0f}M")

    params = M.init_params(cfg, seed=0, device=device)
    task = seq_classification(4096, 8, args.seq, cfg.vocab_size)
    clients = FederatedBatcher(task, args.clients, args.batch,
                               alpha=args.alpha)

    engine = FedEngine(
        FedConfig(method=args.method, rank=8, lr=1e-4,
                  local_steps=args.local_steps),
        loss_fn=lambda p, b: M.loss_fn(p, cfg, b),
        params=params, target_fn=galore_target_fn(cfg))

    eval_b = {k: torch.as_tensor(v, device=device)
              for k, v in clients.eval_batch(128).items()}
    rows = []
    t_start = time.time()
    for rnd in range(args.rounds):
        synchronize(device)
        t0 = time.time()
        metrics = engine.run_round(clients.round_batches(args.local_steps))
        if rnd % 5 == 0 or rnd == args.rounds - 1:
            gp = engine.global_params()
            with torch.no_grad():
                logits, _ = M.forward(gp, cfg, eval_b["tokens"])
                val = float(M.loss_fn(gp, cfg, eval_b))
            acc = float((logits[:, -1].argmax(-1)
                         == eval_b["labels"][:, -1]).float().mean())
            synchronize(device)
            row = {"round": rnd,
                   "local_loss": round(metrics["mean_final_loss"], 4),
                   "val_loss": round(val, 4), "val_acc": acc,
                   "round_sec": round(time.time() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(f"total: {args.rounds} rounds, "
          f"{args.rounds * args.local_steps} local steps/client, "
          f"{time.time() - t_start:.0f}s")
    return rows, engine


if __name__ == "__main__":
    main()
