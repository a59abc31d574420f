"""Port parity for the model families of the eighth slice: the smoke
variants (fp32, 2 layers, d ≤ 256) of paper-llama-like, paper-roberta-like
(LayerNorm, GELU MLP, sinusoidal positions), paper-vit-like and
pixtral-12b (a prefix of 16 stub patch embeddings), mistral-nemo-12b,
command-r-35b (tied embeddings, LayerNorm), granite-moe-1b-a400m (MoE,
4 experts top-2, capacity 1.25 so tokens drop) and musicgen-medium (a
prefix of stub frame embeddings), plus a config whose heads do not span
d_model (4 heads of 128 on d 256, mistral-nemo's layout), JAX package vs
``repro_torch`` on the CPU with the JAX params carried across.

Tolerances, each over the output's scale: ``forward`` logits and the MoE
aux loss 1e-5 (sinusoidal positions sit within 2.4e-7 per unit of
position of JAX's: XLA's and torch's ``exp`` round a frequency one ulp
apart, ROADMAP Queue 3 t); ``loss_fn`` and every parameter's
gradient 1e-5 of its scale (a leaf's largest entry; measured ≤ 1.3e-6);
``prefill`` logits 1e-5 and ``decode_step`` logits, scalar or per-slot
``t``, from the JAX cache 1e-4 (the bf16 KV cache rounds on both sides;
``test_torch_families_decode.py``).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import frontend as jfront
from repro.models import model as jmodel
from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.models import model as tmodel
from repro_torch.models.convert import _to_tensor, params_from_jax
from repro_torch.utils import tree

NEW_ARCHS = ["paper-llama-like", "paper-roberta-like", "paper-vit-like",
             "mistral-nemo-12b", "command-r-35b", "granite-moe-1b-a400m",
             "pixtral-12b", "musicgen-medium"]
WIDE_HEADS = "wide-heads"         # 4 heads of 128 on d_model 256
CASES = NEW_ARCHS + [WIDE_HEADS]
B, L, AUDIO_FRAMES = 2, 12, 4
FWD_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-5, 1e-4


def _configs(case):
    arch = "mistral-nemo-12b" if case == WIDE_HEADS else case
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    if case == WIDE_HEADS:
        wide = dict(name="wide-heads-smoke", n_heads=4, n_kv_heads=2,
                    head_dim=128)
        jcfg = dataclasses.replace(jcfg, **wide)
        tcfg = dataclasses.replace(tcfg, **wide)
        assert tcfg.n_heads * tcfg.hd != tcfg.d_model
    return jcfg, tcfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op pool, and
    beside the JAX work of parallel test workers its idle threads only
    compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES)
def family(request):
    """(jax cfg, torch cfg, jax params, torch params, tokens, labels,
    jax embeds or None) for one case (shared with
    ``test_torch_families_decode.py``)."""
    jcfg, tcfg = _configs(request.param)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, L), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, L), dtype=np.int32)
    labels[0, :3] = -1
    key = jax.random.PRNGKey(2)
    if jcfg.frontend == "vision":
        embeds = jfront.stub_patch_embeddings(key, jcfg, B,
                                              jnp.array([3, 1000]))
    elif jcfg.frontend == "audio":
        embeds = jfront.stub_frame_embeddings(key, jcfg, B, AUDIO_FRAMES)
    else:
        embeds = None
    return jcfg, tcfg, jparams, tparams, tokens, labels, embeds


def _t(x):
    return None if x is None else _to_tensor(np.asarray(x), "cpu", None)


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def test_configs_registered_and_match_jax():
    """Every registered config equals the JAX package's field for field,
    ``param_count`` included; the port's ``ASSIGNED_ARCHS`` is JAX's, and
    ``list_configs`` names what JAX's does."""
    from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
    from repro.configs import list_configs as jlist_configs
    from repro_torch.configs import list_configs
    assert ASSIGNED_ARCHS == JAX_ARCHS
    assert list_configs() == jlist_configs()
    assert set(NEW_ARCHS) | set(ASSIGNED_ARCHS) == set(list_configs())
    for arch in list_configs():
        j, t = jget_config(arch), get_config(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.param_count() == j.param_count()
        assert dataclasses.asdict(jsmoke(j)) == \
            dataclasses.asdict(smoke_variant(t))


def test_forward_and_aux(family):
    jcfg, tcfg, jparams, tparams, tokens, _, embeds = family
    jl, jaux = jmodel.forward(jparams, jcfg, jnp.asarray(tokens), embeds)
    tl, taux = tmodel.forward(tparams, tcfg, torch.from_numpy(tokens),
                              _t(embeds))
    front = 0 if embeds is None else embeds.shape[1]
    assert tuple(tl.shape) == (B, front + L, jcfg.vocab_size)
    assert _rel(tl, jl) <= FWD_TOL
    assert abs(float(taux) - float(jaux)) <= FWD_TOL * max(1.0,
                                                           abs(float(jaux)))
    assert (float(jaux) > 0) == bool(jcfg.n_experts)


def test_loss_and_grad(family):
    jcfg, tcfg, jparams, tparams, tokens, labels, embeds = family
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    if embeds is not None:
        jbatch["embeds"] = embeds
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, jbatch))(jparams)
    leaves = [x.clone().requires_grad_(True) for x in
              tree.tree_leaves(tparams)]
    _, tdef = tree.tree_flatten(tparams)
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    tloss = tmodel.loss_fn(tdef.unflatten(leaves), tcfg, tbatch)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL * abs(float(jloss))
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(jg) == len(leaves)
    worst = max(_rel(x.grad, g) for x, g in zip(leaves, jg)
                if np.max(np.abs(np.asarray(g))) > 0)
    assert worst <= GRAD_TOL, worst


def test_refusals_name_their_items():
    """MLA and the Mamba hybrid are ported: a minimal config of each
    initialises and runs ``forward``. What stays refused is what neither
    package runs, named in the message: a positional scheme outside the
    schema's rope | sinusoidal | none."""
    from repro_torch.configs import ArchConfig
    base = dict(family="dense", n_layers=2, d_model=64, n_heads=2,
                n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
    mla = ArchConfig(name="mla", mla=True, q_lora_rank=16, kv_lora_rank=16,
                     qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, **base)
    hybrid = ArchConfig(name="hybrid", attn_period=2, attn_offset=1, **base)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for cfg in (mla, hybrid):
        params = tmodel.init_params(cfg, device="cpu")
        logits, _ = tmodel.forward(params, cfg, tokens)
        assert tuple(logits.shape) == (1, 4, 64)
    alibi = dataclasses.replace(mla, name="alibi", pos_emb="alibi")
    with pytest.raises(NotImplementedError, match="alibi"):
        tmodel.init_params(alibi, device="cpu")
