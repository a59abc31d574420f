"""Multi-adapter serving in the PyTorch port: one decode batch, many tenants.

    PYTHONPATH=src python examples/serve_batched_torch.py              # card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The JAX example (``examples/serve_batched.py``) in ``repro_torch``: a
base model's target projections are wrapped with per-tenant factored
deltas (``MultiAdapterDelta`` tables from ``launch/adapters.py``); a
heterogeneous batch, every row applying its own adapter over one shared
base product, runs through ``generate_scan``; then the same adapters
serve ``SlotServer`` continuous batching, where requests retire
mid-stream and queued tenants are admitted into freed slots, for the
smoke variants of qwen1.5-0.5b and rwkv6-1.6b. The weights come from a torch generator
seeded with ``--seed``, so the tokens are not the JAX example's; given
the JAX example's params (``convert.params_from_jax``),
:func:`serve_tenants` returns its tokens.
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device, synchronize
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import adapters as adapters_lib
from repro_torch.launch.serve import Request, SlotServer, generate_scan
from repro_torch.models import model as M

ARCHS = ["qwen1.5-0.5b", "rwkv6-1.6b"]
N_ADAPTERS = 8
BATCH, PROMPT, NEW = 8, 24, 16


def tenant_requests(cfg):
    """BATCH requests of PROMPT tokens from ``default_rng(0)``, NEW new
    tokens each, request i on adapter i % N_ADAPTERS (the JAX example's)."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT),
                    max_new=NEW, adapter=i % N_ADAPTERS)
            for i in range(BATCH)]


def serve_tenants(served, cfg, prompts, requests, device):
    """``generate_scan`` over ``prompts`` (BATCH, PROMPT), row i on adapter
    i % N_ADAPTERS, timed after a warm-up; then ``requests`` through
    ``SlotServer`` with half as many slots. Returns (tokens, scan seconds,
    ``SlotServer.run``'s result)."""
    device = resolve_device(device)
    ids = np.arange(BATCH, dtype=np.int32) % N_ADAPTERS
    generate_scan(served, cfg, prompts, NEW, PROMPT + NEW, adapters=ids,
                  device=device)                   # warm-up
    synchronize(device)
    t0 = time.perf_counter()
    out = generate_scan(served, cfg, prompts, NEW, PROMPT + NEW,
                        adapters=ids, device=device)
    synchronize(device)
    dt = time.perf_counter() - t0
    server = SlotServer(served, cfg, slots=BATCH // 2,
                        cache_len=PROMPT + NEW, segment=4, device=device)
    return out, dt, server.run(requests)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for arch in ARCHS:
        cfg = smoke_variant(get_config(arch))
        params = M.init_params(cfg, seed=args.seed, device=device)
        served = adapters_lib.demo_wrap(params, cfg, N_ADAPTERS, rank=4,
                                        seed=args.seed + 1)
        prompts = np.random.default_rng(args.seed + 2).integers(
            0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
        reqs = tenant_requests(cfg)
        out, dt, res = serve_tenants(served, cfg, prompts, reqs, device)
        stats = res["stats"]
        print(f"{arch:20s} scan decode: batch={BATCH} tenants={N_ADAPTERS} "
              f"+{NEW} tokens in {dt:5.2f}s ({BATCH * NEW / dt:7.1f} tok/s) "
              f"sample={out[0, -4:].tolist()}")
        print(f"{'':20s} continuous: {len(reqs)} requests through "
              f"{BATCH // 2} slots, {stats['segments']} segments, "
              f"decode {stats['decode_tok_s']:7.1f} tok/s "
              f"(prefill {stats['prefill_tok_s']:.0f} tok/s)", flush=True)
        results[arch] = {"tokens": out.cpu().numpy(),
                         "outputs": res["outputs"], "stats": stats}
    return results


if __name__ == "__main__":
    main()
