"""The serving example and CLI of the port against the JAX package's, on
the CPU:

- ``launch/serve.py``'s parser gives the reference CLI's default for
  every flag the two share (the port adds only ``--device``): the same
  command serves the same model in each package (ROADMAP Queue 3 y);
- ``examples/serve_batched_torch.py``: given the JAX example's params,
  adapters and prompts (carried across by ``params_from_jax``), its
  ``generate_scan`` tokens and ``SlotServer`` outputs are the JAX
  example's, token for token, for both of its smoke models;
- the serve CLI's ``--smoke`` runs on the CPU for the MLA and the hybrid
  archs, with adapters, in scan and continuous mode.

About 22 s alone and serially (``PYTHONPATH=src JAX_PLATFORMS=cpu python
-m pytest -q -p no:xdist tests/test_torch_serve_batched.py``).
"""
import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.launch import adapters as jadapters
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from test_torch_families import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds inline, caught at
    ``parse_args`` before anything runs."""
    def catch(self, *args, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(jserve, "_env_hygiene", lambda: None)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        jserve.main([])
    return caught.value.args[0]


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions
            if a.dest != "help"}


def test_parser_defaults_match_jax(monkeypatch):
    want = _defaults(_jax_parser(monkeypatch))
    monkeypatch.undo()
    got = _defaults(tserve._parser())
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert got["arch"] == "rwkv6-1.6b"


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b"])
def test_example_tokens_match_jax(arch):
    """The JAX example's steps (params from ``PRNGKey(0)``, 8 tenants of
    rank 4 from ``fold_in(key, 1)``, prompts from ``fold_in(key, 2)``,
    requests from ``default_rng(0)``) against ``serve_tenants`` on the
    same params, adapters and prompts."""
    jex, tex = _load("serve_batched"), _load("serve_batched_torch")
    assert jex.ARCHS == tex.ARCHS and arch in tex.ARCHS
    assert (jex.N_ADAPTERS, jex.BATCH, jex.PROMPT, jex.NEW) == \
        (tex.N_ADAPTERS, tex.BATCH, tex.PROMPT, tex.NEW)
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    key = jax.random.PRNGKey(0)
    params = jax.jit(jmodel.init_params, static_argnums=1)(key, jcfg)
    served = jadapters.demo_wrap(params, jcfg, jex.N_ADAPTERS, rank=4,
                                 key=jax.random.fold_in(key, 1))
    prompts = jax.random.randint(jax.random.fold_in(key, 2),
                                 (jex.BATCH, jex.PROMPT), 0, jcfg.vocab_size)
    ids = jnp.arange(jex.BATCH, dtype=jnp.int32) % jex.N_ADAPTERS
    want = jserve.generate_scan(served, jcfg, prompts, jex.NEW,
                                jex.PROMPT + jex.NEW, adapters=ids)
    rng = np.random.default_rng(0)
    jreqs = [jserve.Request(rid=i,
                            prompt=rng.integers(0, jcfg.vocab_size,
                                                jex.PROMPT),
                            max_new=jex.NEW, adapter=i % jex.N_ADAPTERS)
             for i in range(jex.BATCH)]
    jout = jserve.SlotServer(served, jcfg, slots=jex.BATCH // 2,
                             cache_len=jex.PROMPT + jex.NEW,
                             segment=4).run(jreqs)

    tserved = params_from_jax(jax.tree_util.tree_map(np.asarray, served),
                              "cpu")
    got, _, tout = tex.serve_tenants(tserved, tcfg, np.array(prompts),
                                     tex.tenant_requests(tcfg), "cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert tout["outputs"] == jout["outputs"]


@pytest.mark.parametrize("mode", ["scan", "continuous"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
def test_serve_cli_smoke_on_cpu(arch, mode):
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--mode", mode, "--adapters", "2", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "4"])
    assert res["arch"] == arch + "-smoke" and res["device"] == "cpu"
    assert len(res["sample_row"]) == 4
    assert res["decode_tokens_per_sec"] > 0
