"""Port parity: the sharding rules, the input shapes and the host mesh —
``repro_torch.sharding``, ``repro_torch.configs.shapes`` and
``repro_torch.launch.mesh`` against ``repro.sharding``,
``repro.configs.shapes`` and ``repro.launch.mesh``.

The rules read only axis names and sizes, so both resolve at the
production sizes without devices: JAX against ``AbstractMesh``es of
(16, 16) and (2, 16, 16), the port against ``{axis: size}`` mappings of
the same sizes. Every leaf's spec of every registered arch's full-size
params (the port's tree as meta tensors of JAX's ``eval_shape`` shapes;
the trees' paths and shapes are held equal at smoke size), its GaLore
state (rank 8, the port's own ``galore_init`` on the meta trainables)
and its decode state at ``decode_32k`` is compared; a spec is a tuple
with ``PartitionSpec``'s content. ``SHAPES``, ``shape_variant``,
``cache_len`` and ``input_specs`` (meta tensors: shapes and dtypes) are
compared per arch and shape. A size-1 ``DeviceMesh`` on the CPU takes the
specs as DTensor placements. ≈ 10 s alone.
"""
import dataclasses

import pytest
import torch

import jax

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import shapes as jshapes
from repro.configs import smoke_variant as jsmoke
from repro.core.fed import split_trainable as jsplit
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmesh
from repro.models import model as jmodel
from repro.sharding.rules import ShardingRules as JRules
from repro_torch.configs import (SHAPES, cache_len, get_config, input_specs,
                                 list_configs, shape_variant, smoke_variant)
from repro_torch.core.fed import split_trainable
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as tmodel
from repro_torch.sharding import ShardingRules, placements
from repro_torch.utils import tree

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_configs()


def _abstract_mesh(shape, names):
    """AbstractMesh across jax versions (as ``tests/test_sharding.py``)."""
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _rules(mesh):
    shape, names = MESHES[mesh]
    return (JRules(_abstract_mesh(shape, names)),
            ShardingRules(dict(zip(names, shape))))


def _meta(sds_tree):
    """The port's tree of meta tensors with JAX's ``eval_shape`` shapes."""
    return tree.tree_map(lambda s: torch.empty(s.shape, device="meta"),
                         sds_tree)


def _specs(jtree, ttree):
    jleaves = [tuple(s.spec) for s in jax.tree_util.tree_leaves(jtree)]
    tleaves = [s.spec for s in tree.tree_leaves(ttree)]
    return jleaves, tleaves


def test_registered_archs_are_jax_s():
    assert ARCHS == jlist_configs()


@pytest.fixture(scope="module")
def trees():
    """Per arch: JAX's abstract params, trainables, GaLore state and
    decode state, and the port's meta counterparts."""
    out = {}
    spec = jsteps.TrainSpec(rank=8)
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jp = jax.eval_shape(lambda: jmodel.init_params(
            jax.random.PRNGKey(0), jcfg))
        jtr = jsplit(jp, jsteps.galore_target_fn(jcfg))[0]
        jopt = jax.eval_shape(
            lambda: jsteps.make_galore_tx(jcfg, spec).init(jtr))
        n = jshapes.cache_len(jcfg, jshapes.SHAPES["decode_32k"])
        jds = jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, 128, n))
        tp = _meta(jp)
        ttr = split_trainable(tp, tsteps.galore_target_fn(tcfg))[0]
        topt = tsteps.make_galore_tx(tcfg, tsteps.TrainSpec(rank=8)).init(ttr)
        tds = tmodel.init_decode_state(tcfg, 128, n, device="meta")
        out[arch] = dict(jp=jp, jtr=jtr, jopt=jopt, jds=jds, tp=tp, ttr=ttr,
                         topt=topt, tds=tds)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_agree_at_smoke_size(arch):
    """The meta trees stand for the port's own params: at smoke size
    ``init_params`` gives JAX's paths and shapes."""
    jp = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), jsmoke(jget_config(arch))))
    tp = tmodel.init_params(smoke_variant(get_config(arch)), device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree.tree_flatten_with_path(tp)[0]
    assert [(tree.path_str(p), tuple(x.shape)) for p, x in tl] == \
        [("/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in p),
          tuple(x.shape)) for p, x in jl]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(trees, arch, mesh):
    jr, tr = _rules(mesh)
    t = trees[arch]
    for jtree, ttree in (
            (jr.params_shardings(t["jp"]), tr.params_shardings(t["tp"])),
            (jr.galore_state_shardings(t["jtr"], t["jopt"]),
             tr.galore_state_shardings(t["ttr"], t["topt"])),
            (jr.decode_state_shardings(t["jds"]),
             tr.decode_state_shardings(t["tds"]))):
        jl, tl = _specs(jtree, ttree)
        assert len(tl) == len(jl) > 0
        assert tl == jl


@pytest.mark.parametrize("mesh", MESHES)
def test_rules_and_batch_specs_match_jax(trees, mesh):
    jr, tr = _rules(mesh)
    for arch in ARCHS:
        for path, _ in tree.tree_flatten_with_path(trees[arch]["tp"])[0]:
            p = tree.path_str(path)
            assert tr.param_rule(p) == jr.param_rule(p)
    for shape in ((256, 4096), (32, 32768), (128,), (1,), (2, 7, 3)):
        assert tr.batch_spec(shape) == tuple(jr.batch_spec(shape))
    batch = input_specs(get_config("qwen1.5-0.5b"), SHAPES["train_4k"])
    jbatch = jshapes.input_specs(jget_config("qwen1.5-0.5b"),
                                 jshapes.SHAPES["train_4k"])
    jl, tl = _specs(jr.data_shardings(jbatch), tr.data_shardings(batch))
    assert tl == jl


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_match_jax(arch):
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        jshape = jshapes.SHAPES[name]
        tv, jv = shape_variant(tcfg, shape), jshapes.shape_variant(jcfg,
                                                                   jshape)
        assert tv.sliding_window == jv.sliding_window
        assert cache_len(tv, shape) == jshapes.cache_len(jv, jshape)
        got, want = input_specs(tcfg, shape), jshapes.input_specs(jcfg,
                                                                  jshape)
        assert sorted(got) == sorted(want)
        gl = tree.tree_leaves(got)
        wl = jax.tree_util.tree_leaves(want)
        assert all(x.device.type == "meta" for x in gl)
        assert [(tuple(x.shape), _dtype(x)) for x in gl] == \
            [(tuple(x.shape), str(x.dtype)) for x in wl]


def test_host_mesh_takes_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_host_mesh(1, device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh.device_type == "cpu"
    rules = ShardingRules(mesh)
    params = tmodel.init_params(smoke_variant(get_config("qwen1.5-0.5b")),
                                device="cpu")
    # on a size-1 mesh every axis divides: JAX's rules on its one-device
    # mesh give the same specs
    jparams = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), jsmoke(jget_config("qwen1.5-0.5b"))))
    jl, tl = _specs(JRules(jmesh(1)).params_shardings(jparams),
                    rules.params_shardings(params))
    assert tl == jl
    wq = params["blocks"][0]["attn"]["wq"]
    sh = rules.params_shardings(params)["blocks"][0]["attn"]["wq"]
    assert sh.spec == (None, "data", "model")
    assert sh.placements() == [Shard(1), Shard(2)]
    assert placements((), mesh) == [Replicate(), Replicate()]
    dt = distribute_tensor(wq, mesh, sh.placements())
    assert dt.placements == (Shard(1), Shard(2))
    assert torch.equal(dt.to_local(), wq)
    assert torch.equal(dt.full_tensor(), wq)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh(1)
