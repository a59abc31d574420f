"""Multi-tenant low-rank serving (port of ``repro/launch/serve.py``).

Three serving paths over the same model:

- :func:`generate`       eager per-token loop, the parity oracle.
- :func:`generate_scan`  the decode loop writing into a preallocated
                         token buffer with no host synchronisation per
                         token; greedy output is bit-identical to
                         :func:`generate`. (JAX lowers this to one
                         ``lax.scan``; capturing it in a CUDA graph is
                         later work.)
- :class:`SlotServer`    continuous batching: requests occupy slots of a
                         fixed decode batch, finished sequences retire
                         mid-segment via EOS/budget masks, queued requests
                         are admitted into freed slots between segments.

At temperature > 0 every path draws tokens as JAX does, with
``utils.prng.categorical`` (the Gumbel-max draw on threefry bits) along
JAX's key chains from ``key = PRNGKey(seed)``: :func:`generate` samples
the first token with ``key`` and splits ``key, sub = split(key)`` before
each later one; :func:`generate_scan` samples step i with ``fold_in(key,
i)``; :class:`SlotServer` splits its key at each admission and samples
step i of a segment with ``fold_in(key, base + i)``, ``base`` counting
the steps of all earlier segments. Greedy decoding derives no key.

Per-row heterogeneous adapters ride along on all three: pass ``adapters``
(B,) int ids and params whose target leaves are ``MultiAdapterDelta``
tables (:mod:`repro_torch.launch.adapters`). Everything runs under
``torch.inference_mode()`` on ``device`` (default ``"cuda"``; the CPU only
when asked).

Two model families serve: the dense GQA family (qwen1.5-0.5b, the CLI's
default ``--arch``) and RWKV6 (rwkv6-1.6b), whose recurrent state takes the
place of the KV cache:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --adapters 8 --adapter-rank 16 --mode continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --adapters 8 --adapter-rank 16 --mode continuous
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, synchronize
from ..configs import get_config, smoke_variant
from ..models import layers
from ..models import model as model_lib
from ..utils import prng, tree

PAD_ID = 0   # emitted by retired slots inside a segment; never surfaced


def _sample(logits, key, temperature):
    """Greedy argmax when temperature <= 0 (``key`` unused, may be None),
    else ``categorical(key, logits / temperature)``: JAX's draw, token for
    token. Every row of the (B, V) noise is drawn, retired slots' too, so
    the bits line up with JAX's."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature).to(torch.int32)


def _split(key):
    """``key, sub = jax.random.split(key)``."""
    ks = prng.split(key)
    return ks[0], ks[1]


def _adapter_count(params) -> Optional[int]:
    """G of the ``MultiAdapterDelta`` tables in ``params``; None for plain
    params, which ignore adapter ids."""
    is_leaf = lambda x: isinstance(x, layers.MultiAdapterDelta)  # noqa: E731
    for leaf in tree.tree_leaves(params, is_leaf=is_leaf):
        if is_leaf(leaf):
            return int(leaf.scales.shape[-1])
    return None


def _check_adapter(adapter: int, count: Optional[int]) -> None:
    """Refuse an id outside the served tables: the plain version would
    raise on it and the kernel would clamp it to another tenant's
    adapter."""
    if count is not None and not 0 <= adapter < count:
        raise ValueError(f"adapter id {adapter} outside the {count} "
                         "adapters the params carry")


def _ids(adapters, batch: int, device, params) -> Optional[torch.Tensor]:
    if adapters is None:
        return None
    ids = torch.as_tensor(adapters, dtype=torch.int32, device=device)
    if ids.shape != (batch,):
        raise ValueError(f"adapters must be ({batch},), got "
                         f"{tuple(ids.shape)}")
    count = _adapter_count(params)
    if batch and count is not None:
        _check_adapter(int(ids.min()), count)
        _check_adapter(int(ids.max()), count)
    return ids


def _prefill(params, cfg, prompts, cache_len, ids, device):
    state = model_lib.init_decode_state(cfg, prompts.shape[0], cache_len,
                                        device=device)
    with layers.adapter_ids(ids):
        return model_lib.prefill(params, cfg, prompts, state)


# --------------------------------------------------------------------------
# Whole-sequence generation
# --------------------------------------------------------------------------

@torch.inference_mode()
def generate(params, cfg, prompts, new_tokens: int, cache_len: int,
             temperature: float = 0.0, seed: int = 0, adapters=None,
             device="cuda"):
    """prompts (B, L) -> (B, L + new_tokens) int32. Greedy when
    temperature == 0. The eager per-token loop — the parity oracle for
    :func:`generate_scan`. ``adapters`` (B,) int ids select each row's
    factor set when params carry ``MultiAdapterDelta`` leaves."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    ids = _ids(adapters, prompts.shape[0], dev, params)
    key = prng.PRNGKey(seed, device=dev)
    logits, state = _prefill(params, cfg, prompts, cache_len, ids, dev)
    tok = _sample(logits, key, temperature)
    out = [tok]
    for _ in range(new_tokens - 1):
        sub = None
        if temperature > 0:
            key, sub = _split(key)
        with layers.adapter_ids(ids):
            logits, state = model_lib.decode_step(params, cfg, tok, state)
        tok = _sample(logits, sub, temperature)
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, dim=1)], dim=1)


def _scan_decode(params, cfg, tok0, state, steps: int, ids, key,
                 temperature: float):
    """``steps`` decode steps after ``tok0``, each token written into a
    preallocated (B, steps) device buffer; nothing reads the device
    until the caller does. Step i samples with ``fold_in(key, i)``."""
    toks = torch.empty((tok0.shape[0], steps), dtype=torch.int32,
                       device=tok0.device)
    tok = tok0
    with layers.adapter_ids(ids):
        for i in range(steps):
            logits, state = model_lib.decode_step(params, cfg, tok, state)
            sub = prng.fold_in(key, i) if temperature > 0 else None
            tok = _sample(logits, sub, temperature)
            toks[:, i] = tok
    return toks


@torch.inference_mode()
def generate_scan(params, cfg, prompts, new_tokens: int, cache_len: int,
                  temperature: float = 0.0, seed: int = 0, adapters=None,
                  device="cuda"):
    """Fused twin of :func:`generate` (see the module docstring). Greedy
    output is bit-identical to the eager oracle."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    ids = _ids(adapters, prompts.shape[0], dev, params)
    key = prng.PRNGKey(seed, device=dev)
    logits, state = _prefill(params, cfg, prompts, cache_len, ids, dev)
    tok0 = _sample(logits, key, temperature)
    if new_tokens <= 1:
        return torch.cat([prompts, tok0[:, None]], dim=1)
    toks = _scan_decode(params, cfg, tok0, state, new_tokens - 1, ids, key,
                        float(temperature))
    return torch.cat([prompts, tok0[:, None], toks], dim=1)


# --------------------------------------------------------------------------
# Continuous batching
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` (L,) int tokens, decode budget
    ``max_new``, and the adapter id its rows should apply."""
    rid: int
    prompt: Any
    max_new: int
    adapter: int = 0


def _insert(state, tok, slot: int, sub_state, sub_tok) -> None:
    """Write one prefilled request's layer-state rows (KV cache, or RWKV
    shifts and WKV state), position and first token into slot ``slot`` of
    the live batched state, in place (the JAX version builds new arrays).
    Layer-state leaves are stacked (nb, B, ...), so the slot axis is 1."""
    for big, small in zip(state.layers, sub_state.layers):
        for b_leaf, s_leaf in zip(big, small):
            b_leaf[:, slot] = s_leaf[:, 0].to(b_leaf.dtype)
    state.t[slot] = sub_state.t
    tok[slot] = sub_tok[0]


class SlotServer:
    """Slot-based continuous batching over fixed-shape decode segments.

    A fixed decode batch of ``slots`` rows runs ``segment``-step segments.
    Rows retire mid-segment (EOS or budget) via device-side masks; between
    segments the host drains finished slots and admits queued requests
    into the free ones — per-request prefill, then an in-place insert of
    the slot's cache rows, position and first token.
    """

    def __init__(self, params, cfg, *, slots: int, cache_len: int,
                 segment: int = 8, eos_id: int = -1,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.segment = int(segment)
        self.eos_id = int(eos_id)          # -1 = no EOS, budget-only
        self.temperature = float(temperature)
        self.key = prng.PRNGKey(seed, device=self.device)
        self._step_base = 0     # decode steps of all earlier segments
        self.n_adapters = _adapter_count(params)
        # The JAX version casts its state to decode_step's output dtypes
        # here (RWKV shifts start bf16 and come out in the activation
        # dtype). init_decode_state already allocates those dtypes, and the
        # in-place writes refuse any other.
        self.state = model_lib.init_decode_state(cfg, self.slots, cache_len,
                                                 per_slot=True,
                                                 device=self.device)
        self.tok = torch.zeros((self.slots,), dtype=torch.int32,
                               device=self.device)
        self.ids = torch.zeros((self.slots,), dtype=torch.int32,
                               device=self.device)
        self.active = np.zeros(self.slots, bool)
        self.remaining = np.zeros(self.slots, np.int32)
        self.rid = np.full(self.slots, -1, np.int64)
        self.queue: List[Request] = []
        self.outputs: Dict[int, List[int]] = {}
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "segments": 0, "admitted": 0}

    def submit(self, request: Request) -> None:
        _check_adapter(request.adapter, self.n_adapters)
        self.queue.append(request)

    def _admit(self) -> None:
        """Fill free slots from the queue (per-request prefill + insert)."""
        for slot in range(self.slots):
            if not self.queue:
                return
            if self.active[slot]:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                     device=self.device)[None]
            sub_ids = torch.full((1,), req.adapter, dtype=torch.int32,
                                 device=self.device)
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, sub_state = _prefill(self.params, self.cfg, prompt,
                                         self.cache_len, sub_ids, self.device)
            sub = None
            if self.temperature > 0:
                self.key, sub = _split(self.key)
            tok1 = _sample(logits, sub, self.temperature)
            first = int(tok1[0])               # waits for the device
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += int(prompt.shape[1])
            _insert(self.state, self.tok, slot, sub_state, tok1)
            self.ids[slot] = req.adapter
            self.outputs[req.rid] = [first]
            done = (req.max_new <= 1 or
                    (self.eos_id >= 0 and first == self.eos_id))
            self.rid[slot] = -1 if done else req.rid
            self.active[slot] = not done
            self.remaining[slot] = max(req.max_new - 1, 0)
            self.stats["admitted"] += 1

    def _segment(self, act, rem):
        """``segment`` decode steps over the live batch with device-side
        retirement: an inactive row emits PAD_ID (its state keeps advancing
        harmlessly; admission overwrites the whole slot). Step i samples
        with ``fold_in(key, base + i)``."""
        toks = torch.empty((self.slots, self.segment), dtype=torch.int32,
                           device=self.device)
        tok, state = self.tok, self.state
        with layers.adapter_ids(self.ids):
            for i in range(self.segment):
                logits, state = model_lib.decode_step(self.params, self.cfg,
                                                      tok, state)
                sub = (prng.fold_in(self.key, self._step_base + i)
                       if self.temperature > 0 else None)
                nxt = _sample(logits, sub, self.temperature)
                nxt = torch.where(act, nxt, torch.full_like(nxt, PAD_ID))
                rem = torch.where(act, rem - 1, rem)
                act = act & (rem > 0)
                if self.eos_id >= 0:
                    act = act & (nxt != self.eos_id)
                toks[:, i] = nxt
                tok = nxt
        return tok, state, act, rem, toks

    def _run_segment(self) -> None:
        """One segment over the live batch; drain outputs after."""
        act_before = self.active.copy()
        rem_before = self.remaining.copy()
        rid_before = self.rid.copy()
        synchronize(self.device)
        t0 = time.perf_counter()
        self.tok, self.state, act, rem, toks = self._segment(
            torch.as_tensor(self.active, device=self.device),
            torch.as_tensor(self.remaining, device=self.device))
        toks_np = toks.cpu().numpy()           # waits for the device
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["segments"] += 1
        self._step_base += self.segment
        self.active = act.cpu().numpy().copy()
        self.remaining = rem.cpu().numpy().astype(np.int32)
        for slot in np.nonzero(act_before)[0]:
            take = min(self.segment, int(rem_before[slot]))
            for t in toks_np[slot, :take]:
                self.outputs[int(rid_before[slot])].append(int(t))
                self.stats["decode_tokens"] += 1
                if self.eos_id >= 0 and int(t) == self.eos_id:
                    break
            if not self.active[slot]:
                self.rid[slot] = -1            # retired: slot is free

    @torch.inference_mode()
    def run(self, requests=()) -> Dict[str, Any]:
        """Serve ``requests`` (plus anything already queued) to completion.

        Returns ``{"outputs": {rid: [new tokens...]}, "stats": {...}}`` —
        outputs include the prefill-sampled first token, truncated at EOS.
        """
        for r in requests:
            self.submit(r)
        while self.queue or self.active.any():
            self._admit()
            if self.active.any():
                self._run_segment()
        return {"outputs": self.outputs, "stats": self.stat_summary()}

    def stat_summary(self) -> Dict[str, Any]:
        s = dict(self.stats)
        s["prefill_tok_s"] = (s["prefill_tokens"] / s["prefill_s"]
                              if s["prefill_s"] > 0 else 0.0)
        s["decode_tok_s"] = (s["decode_tokens"] / s["decode_s"]
                             if s["decode_s"] > 0 else 0.0)
        return s


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", choices=("eager", "scan", "continuous"),
                    default="scan")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch (slot count in continuous mode)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="KV slots (0 = prompt+new)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adapters", type=int, default=0,
                    help="G distinct demo adapters (0 = plain params)")
    ap.add_argument("--adapter-rank", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous mode: requests to serve (0 = 2x slots)")
    ap.add_argument("--segment", type=int, default=8)
    ap.add_argument("--eos-id", type=int, default=-1)
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
    rng = np.random.default_rng(args.seed + 1)
    cache = args.cache_len or (args.prompt_len + args.new_tokens)

    row_ids = None
    if args.adapters:
        from . import adapters as adapters_lib
        params = adapters_lib.demo_wrap(params, cfg, args.adapters,
                                        rank=args.adapter_rank,
                                        seed=args.seed + 2)
        row_ids = np.arange(args.batch, dtype=np.int32) % args.adapters

    res = {"arch": cfg.name, "mode": args.mode, "batch": args.batch,
           "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
           "adapters": args.adapters, "device": str(dev)}
    if dev.type == "cuda":
        res["device_name"] = torch.cuda.get_device_name(dev)

    if args.mode == "continuous":
        n_req = args.requests or 2 * args.batch
        prompts_np = rng.integers(0, cfg.vocab_size,
                                  (n_req, args.prompt_len), dtype=np.int32)
        reqs = [Request(rid=i, prompt=prompts_np[i], max_new=args.new_tokens,
                        adapter=(i % args.adapters) if args.adapters else 0)
                for i in range(n_req)]
        server = SlotServer(params, cfg, slots=args.batch, cache_len=cache,
                            segment=args.segment, eos_id=args.eos_id,
                            temperature=args.temperature, seed=args.seed,
                            device=dev)
        out = server.run(reqs)
        s = out["stats"]
        total = s["prefill_s"] + s["decode_s"]
        res.update({
            "requests": n_req, "segments": s["segments"],
            "prefill_sec": s["prefill_s"], "decode_sec": s["decode_s"],
            "prefill_tokens_per_sec": s["prefill_tok_s"],
            "decode_tokens_per_sec": s["decode_tok_s"],
            "sec": total,
            "tokens_per_sec": s["decode_tokens"] / total if total > 0 else 0.0,
            "sample_row": out["outputs"][0]})
        print(json.dumps(res))
        return res

    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                     dtype=np.int32), device=dev)
    ids = _ids(row_ids, args.batch, dev, params)
    timing = {}

    @torch.inference_mode()
    def run_once(record: bool):
        key = prng.PRNGKey(args.seed, device=dev)
        synchronize(dev)                   # fence before the clock
        t0 = time.perf_counter()
        logits, state = _prefill(params, cfg, prompts, cache, ids, dev)
        synchronize(dev)
        t1 = time.perf_counter()
        tok0 = _sample(logits, key, args.temperature)
        outl = [tok0]
        if args.mode == "scan":
            if args.new_tokens > 1:
                outl.append(_scan_decode(params, cfg, tok0, state,
                                         args.new_tokens - 1, ids, key,
                                         args.temperature))
            out = torch.cat([prompts, tok0[:, None]] + outl[1:], dim=1)
        else:
            k, tok = key, tok0
            for _ in range(args.new_tokens - 1):
                sub = None
                if args.temperature > 0:
                    k, sub = _split(k)
                with layers.adapter_ids(ids):
                    logits_i, state = model_lib.decode_step(params, cfg, tok,
                                                            state)
                tok = _sample(logits_i, sub, args.temperature)
                outl.append(tok)
            out = torch.cat([prompts, torch.stack(outl, dim=1)], dim=1)
        synchronize(dev)
        t2 = time.perf_counter()
        if record:
            timing["prefill_s"] = t1 - t0
            timing["decode_s"] = t2 - t1
        return out

    run_once(record=False)                 # warm-up (kernel build), not timed
    out = run_once(record=True)

    pf, dc = timing["prefill_s"], timing["decode_s"]
    total = pf + dc
    res.update({
        "prefill_sec": pf, "decode_sec": dc,
        "prefill_tokens_per_sec":
            args.batch * args.prompt_len / pf if pf > 0 else 0.0,
        "decode_tokens_per_sec":
            args.batch * args.new_tokens / dc if dc > 0 else 0.0,
        "sec": total,
        "tokens_per_sec": args.batch * args.new_tokens / total
        if total > 0 else 0.0,
        "sample_row": out[0, -args.new_tokens:].tolist()})
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
