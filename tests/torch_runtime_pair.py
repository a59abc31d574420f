"""Shared set-up of the runtime parity tests (``test_torch_runtime*.py``):
JAX's ``ShardedFederation`` on ``make_host_mesh(1)`` beside the port's on
a one-device CPU mesh, the port's state carried across from JAX's after
construction (``models/convert.py``), both fed the same seeded numpy
batches.

Set-up: smoke models, C = 3 clients, T = 2 local steps, batch 2 × 8,
rank 4, lr 1e-3, ``TrainSpec(refresh_mode="random")`` unless a case says
otherwise, as JAX's own runtime tests (``tests/test_fed_round_fused.py::
_runtime_setup``).

Tolerances, those of ``test_torch_fed.py`` (ROADMAP Queue 3 e): per-step
losses ≤ 1e-5; global target leaves ≤ 1e-4 and every stacked optimizer
buffer (bases, m, ṽ) ≤ 3e-4 of its leaf's max |·|; step counts and seeds
equal.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.fedsim import ShardedFederation as JFed
from repro.launch.mesh import make_host_mesh as jmesh
from repro.launch.steps import TrainSpec as JSpec
from repro_torch.configs import get_config, smoke_variant
from repro_torch.fedsim import ShardedFederation
from repro_torch.kernels import ops as kops
from repro_torch.core import galore as tgal
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import TrainSpec
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.utils import tree

C, T, B, L, RANK = 3, 2, 2, 8, 4
LOSS_TOL, PARAM_TOL, STATE_TOL = 1e-5, 1e-4, 3e-4
SPEC = dict(rank=RANK, lr=1e-3, local_steps=T, refresh_mode="random")
QWEN, DEEPSEEK = "qwen1.5-0.5b", "deepseek-v2-236b"


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def batches(vocab, seed, k_rounds=None):
    """Seeded tokens (C, T, B, L) (with a leading K) as both packages'
    language-modelling batch."""
    lead = (C, T, B, L) if k_rounds is None else (k_rounds, C, T, B, L)
    toks = np.random.default_rng(seed).integers(0, vocab, lead)
    toks = toks.astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def carry(jf, tf):
    """The port's federation takes JAX's global trainables, frozen params
    and stacked optimizer states."""
    tf.global_trainable = params_from_jax(_np(jf.global_trainable), "cpu")
    tf.frozen = params_from_jax(_np(jf.frozen), "cpu")
    tf.opt_states = opt_state_from_jax(_np(jf.opt_states), "cpu")


def pair(arch=QWEN, spec=None, **fed_kw):
    """(JAX federation, port federation, both configs) from one start."""
    jcfg = jsmoke(jget_config(arch))
    tcfg = smoke_variant(get_config(arch))
    sp = {**SPEC, **(spec or {})}
    jf = JFed(jcfg, JSpec(**sp), jmesh(1), C, **{"state_sync": "ajive",
                                                  **fed_kw})
    tf = ShardedFederation(tcfg, TrainSpec(**sp),
                           make_host_mesh(1, device="cpu"), C,
                           **{"state_sync": "ajive", **fed_kw})
    carry(jf, tf)
    return jf, tf, jcfg, tcfg


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def state(fed_states, leaves):
    """Array leaves and scalar leaves (counts, seeds) of a stacked
    optimizer state, as numpy."""
    arrays, scalars = [], []
    for x in leaves(fed_states):
        x = x.detach().float().numpy() if torch.is_tensor(x) else \
            np.asarray(x)
        (arrays if x.ndim > 1 else scalars).append(x)
    return arrays, scalars


def record(jf, tf, jm, tm):
    """Both federations' losses, global leaves and stacked states after a
    call."""
    ja, js = state(jf.opt_states, jax.tree_util.tree_leaves)
    ta, ts = state(tf.opt_states, tree.tree_leaves)
    return dict(
        jloss=np.asarray(jm["losses"]), tloss=tm["losses"].numpy(),
        jglobal=[np.asarray(x) for x in
                 jax.tree_util.tree_leaves(jf.global_trainable)],
        tglobal=[x.float().numpy() for x in
                 tree.tree_leaves(tf.global_trainable)],
        jstate=ja, tstate=ta,
        jscalar=[int(np.unique(x)[0]) for x in js],
        tscalar=[int(np.unique(x)[0]) for x in ts],
        jmean=jm["mean_final_loss"], tmean=tm["mean_final_loss"])


def run_round(jf, tf, b, **call):
    jm = jf.run_round(_jnp(b), **call)
    tm = tf.run_round(b, **call)
    return record(jf, tf, jm, tm)


def run_rounds(jf, tf, b, **call):
    jm = jf.run_rounds(_jnp(b), **call)
    tm = tf.run_rounds(b, **call)
    return record(jf, tf, jm, tm)


def assert_matches(rec, state_tol=STATE_TOL, param_tol=PARAM_TOL):
    assert rec["tloss"].shape == rec["jloss"].shape
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert abs(rec["tmean"] - rec["jmean"]) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) > 0
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.shape == want.shape
        assert rel(got, want) <= param_tol
    assert len(rec["tstate"]) == len(rec["jstate"]) > 0
    for got, want in zip(rec["tstate"], rec["jstate"]):
        assert got.shape == want.shape
        assert rel(got, want) <= state_tol
    assert rec["tscalar"] == rec["jscalar"]


class Calls:
    """Counts the port's calls to the kernel dispatchers and to the two
    local-step reads while active."""
    NAMES = ((kops, ("galore_precond_step", "lowrank_linear",
                     "batched_small_eigh")),
             (tgal, ("lift_client_trainable", "liftfree_value_and_grad")))

    def __enter__(self):
        self.n, self.orig = {}, []
        for mod, names in self.NAMES:
            for name in names:
                fn = getattr(mod, name)
                self.orig.append((mod, name, fn))

                def counted(*a, _fn=fn, _name=name, **k):
                    self.n[_name] = self.n.get(_name, 0) + 1
                    return _fn(*a, **k)

                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)
        return False
