"""Federated training launcher (port of ``repro/launch/train.py``).

Runs FedGaLore (or any method of ``core.fed.METHODS``) on the synthetic
classification task with the Dirichlet(α) protocol, one JSON line per
round (``local_loss``, ``val_loss``, ``val_acc``, ``sec``), on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --smoke --method fedgalore --rounds 20 \\
      --clients 8 --participate 4 --alpha 0.5 [--device cpu]

The weights come from a torch generator seeded with ``--seed``, so the
numbers are not the JAX CLI's, only its trend. The evaluation forward
runs under
``torch.no_grad()``, so its attention goes through ``flash_attention`` as
serving prefill's does. ``--ckpt-dir`` saves the global params after every
round (``checkpoint/io.py``).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device, synchronize
from ..checkpoint import save
from ..configs import get_config, smoke_variant
from ..core.fed import METHODS, FedConfig, FedEngine
from ..data import FederatedBatcher, seq_classification
from ..models import model as model_lib
from .steps import galore_target_fn


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant (CPU-scale)")
    ap.add_argument("--method", default="fedgalore", choices=list(METHODS))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--participate", type=int, default=0,
                    help="clients per round (0 = all)")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet alpha (None = IID)")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--examples", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)

    params = model_lib.init_params(cfg, seed=args.seed, device=dev)

    task = seq_classification(args.examples, args.classes, args.seq,
                              cfg.vocab_size, seed=args.seed)
    batcher = FederatedBatcher(task, args.clients, args.batch,
                               alpha=args.alpha, seed=args.seed)

    def loss(p, batch):
        return model_lib.loss_fn(p, cfg, batch)

    fed_cfg = FedConfig(method=args.method, rank=args.rank, lr=args.lr,
                        local_steps=args.local_steps, seed=args.seed)
    engine = FedEngine(fed_cfg, loss, params,
                       target_fn=galore_target_fn(cfg))

    eval_batch = {k: torch.as_tensor(v, device=dev) for k, v in
                  batcher.eval_batch(min(256, args.examples)).items()}

    history = []
    for rnd in range(args.rounds):
        synchronize(dev)
        t0 = time.time()
        clients = (batcher.sample_clients(args.participate)
                   if args.participate else None)
        batches = batcher.round_batches(args.local_steps, clients)
        metrics = engine.run_round(batches)
        gp = engine.global_params()
        with torch.no_grad():
            logits, _ = model_lib.forward(gp, cfg, eval_batch["tokens"],
                                          eval_batch.get("embeds"))
            val = float(model_lib.loss_fn(gp, cfg, eval_batch))
        lab = eval_batch["labels"][:, -1]
        acc = float((logits[:, -1].argmax(-1) == lab).float().mean())
        synchronize(dev)
        row = {"round": rnd, "local_loss": metrics["mean_final_loss"],
               "val_loss": val, "val_acc": acc,
               "sec": round(time.time() - t0, 2)}
        history.append(row)
        print(json.dumps(row), flush=True)
        if args.ckpt_dir:
            save(args.ckpt_dir, rnd, gp)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
