"""Port parity of the eighth slice's families at the serving entry
points: ``prefill`` over the frontend prefix and the tokens, then
``decode_step`` with a scalar or a per-slot ``t``, for every case of
``test_torch_families.py`` (the smoke variants of the eight new configs
and the wide-heads layout), and greedy ``generate`` with per-row adapters
for the MoE, sinusoidal and wide-heads models; JAX package vs
``repro_torch`` on the CPU with the JAX params carried across.

Tolerances over the logits' scale: ``prefill`` 1e-5; ``decode_step``
from JAX's own bf16 cache 1e-4 (the KV cache rounds on both sides);
greedy tokens identical.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.launch import adapters as jadapters
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from test_torch_families import (B, DECODE_TOL, FWD_TOL, L, WIDE_HEADS,  # noqa: F401
                                 _configs, _one_torch_thread, _rel, _t,
                                 family)


@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode(family, per_slot):
    """Prefill over the prefix and L - 1 tokens, then one decode step with
    ``t`` scalar or per slot (the slots at different depths: row 1 one
    position behind), from JAX's cache."""
    jcfg, tcfg, jparams, tparams, tokens, _, embeds = family
    front = 0 if embeds is None else embeds.shape[1]
    cache = front + L + 4
    jstate = jmodel.init_decode_state(jcfg, B, cache)
    jl, jstate = jmodel.prefill(jparams, jcfg, jnp.asarray(tokens[:, :-1]),
                                jstate, embeds)
    with torch.inference_mode():
        tstate = tmodel.init_decode_state(tcfg, B, cache, device="cpu")
        tl, tstate = tmodel.prefill(tparams, tcfg,
                                    torch.from_numpy(tokens[:, :-1]),
                                    tstate, _t(embeds))
    assert int(tstate.t) == front + L - 1 == int(jstate.t)
    assert _rel(tl, jl) <= FWD_TOL
    if per_slot:
        t = jnp.array([front + L - 1, front + L - 2], jnp.int32)
        jstate = jstate._replace(t=t)
    jd, _ = jmodel.decode_step(jparams, jcfg, jnp.asarray(tokens[:, -1]),
                               jstate)
    tstate = decode_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jstate), "cpu")
    with torch.inference_mode():
        td, tstate = tmodel.decode_step(tparams, tcfg,
                                        torch.from_numpy(tokens[:, -1]),
                                        tstate)
    assert _rel(td, jd) <= DECODE_TOL
    assert tstate.t.ndim == (1 if per_slot else 0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-medium",
                                  WIDE_HEADS])
def test_serving_greedy_tokens_match_jax(arch):
    """``generate`` with three adapters (rank 3) on the serving target set
    (experts and routers frozen): the port's greedy tokens are JAX's."""
    jcfg, tcfg = _configs(arch)
    params = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    store = jadapters.AdapterStore(params, jadapters.serving_target_fn(jcfg),
                                   3, 3)
    rng = np.random.default_rng(4)
    for i in range(3):
        basis, rt = store.random_factors(rng, rt_scale=0.05)
        store.put(i, rt, basis, scale=1.0 - 0.01 * i)
    served = store.wrap(params)
    tserved = params_from_jax(jax.tree_util.tree_map(np.asarray, served),
                              "cpu")
    prompts = rng.integers(0, jcfg.vocab_size, (3, 8), dtype=np.int32)
    ids = np.array([2, 0, 1], np.int32)
    want = jserve.generate(served, jcfg, jnp.asarray(prompts), 4, 16,
                           adapters=jnp.asarray(ids))
    got = tserve.generate(tserved, tcfg, prompts, 4, 16, adapters=ids,
                          device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
