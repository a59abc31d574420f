"""Port parity: the crash-safe checkpoint writer —
``repro_torch.checkpoint`` against ``repro.checkpoint``, case for case of
``tests/test_checkpoint.py``, and across packages: a JAX ``save`` read by
the port's ``restore`` and the port's ``save`` read by JAX's, exactly, on
a tree with dicts, lists, a NamedTuple, ``None`` leaves and bf16."""
import os
from typing import NamedTuple

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import checkpoint as jckpt
from repro_torch.checkpoint import gc_steps, latest_step, restore, save
from repro_torch.utils import tree


class Moments(NamedTuple):
    m: object
    v: object


def test_roundtrip(tmp_path):
    t = {"a": torch.arange(6).reshape(2, 3).float(),
         "nested": {"b": torch.ones(4, dtype=torch.bfloat16)},
         "list": [torch.zeros(2), torch.full((3,), 7.0)]}
    save(str(tmp_path), 3, t)
    out = restore(str(tmp_path), 3, t)
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(out)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_latest_step(tmp_path):
    t = {"x": torch.zeros(1)}
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 1, t)
    save(str(tmp_path), 5, t)
    assert latest_step(str(tmp_path)) == 5


def test_save_is_atomic_no_tmp_residue(tmp_path):
    save(str(tmp_path), 2, {"x": torch.ones(3)})
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt_00000002.json",
                                                 "ckpt_00000002.npz"]


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def test_restore_truncated_payload_raises(tmp_path):
    t = {"x": torch.arange(4096, dtype=torch.float32)}
    _truncate(save(str(tmp_path), 7, t))
    with pytest.raises(FileNotFoundError, match="truncated"):
        restore(str(tmp_path), 7, t)


def test_latest_step_skips_truncated_and_missing_payloads(tmp_path):
    t = {"x": torch.arange(4096, dtype=torch.float32)}
    save(str(tmp_path), 1, t)
    _truncate(save(str(tmp_path), 5, t))
    assert latest_step(str(tmp_path)) == 1
    save(str(tmp_path), 9, t)
    os.remove(os.path.join(str(tmp_path), "ckpt_00000009.npz"))
    assert latest_step(str(tmp_path)) == 1


def test_keep_last_gc_retains_newest_valid(tmp_path):
    t = {"x": torch.arange(16, dtype=torch.float32)}
    for s in (1, 3, 5, 7):
        save(str(tmp_path), s, t, keep_last=2)
    names = os.listdir(str(tmp_path))
    assert sorted(f for f in names if f.endswith(".npz")) == [
        "ckpt_00000005.npz", "ckpt_00000007.npz"]
    assert "ckpt_00000001.json" not in names
    assert "ckpt_00000003.json" not in names
    for s in (5, 7):
        assert torch.equal(restore(str(tmp_path), s, t)["x"], t["x"])


def test_gc_never_deletes_newest_valid_payload(tmp_path):
    t = {"x": torch.arange(4096, dtype=torch.float32)}
    save(str(tmp_path), 2, t)
    for s in (5, 8):
        _truncate(save(str(tmp_path), s, t))
    gc_steps(str(tmp_path), keep_last=1)
    assert sorted(f for f in os.listdir(str(tmp_path))
                  if f.endswith(".npz")) == ["ckpt_00000002.npz"]
    assert latest_step(str(tmp_path)) == 2
    assert torch.equal(restore(str(tmp_path), 2, t)["x"], t["x"])
    with pytest.raises(ValueError, match="keep_last"):
        gc_steps(str(tmp_path), keep_last=0)


def test_restore_rejects_nonfinite_payload(tmp_path):
    t = {"w": torch.ones(4), "steps": torch.arange(4, dtype=torch.int32)}
    bad = {"w": torch.tensor([1.0, float("nan"), 3.0, float("inf")]),
           "steps": t["steps"]}
    save(str(tmp_path), 4, bad)
    with pytest.raises(ValueError, match="non-finite"):
        restore(str(tmp_path), 4, t)
    out = restore(str(tmp_path), 4, t, reject_nonfinite=False)
    assert torch.isnan(out["w"][1])
    save(str(tmp_path), 6, t)
    out = restore(str(tmp_path), 6, t)
    assert torch.equal(out["steps"], t["steps"])
    assert out["steps"].dtype == torch.int32


def test_restores_namedtuple_state(tmp_path):
    from repro_torch.core.galore import GaloreConfig, galore_init
    st = galore_init(GaloreConfig(rank=2), {"w": torch.ones(8, 8)})
    save(str(tmp_path), 0, st, name="opt")
    out = restore(str(tmp_path), 0, st, name="opt")
    assert type(out) is type(st) and out.count == st.count
    assert torch.equal(out.blocks["w"].basis, st.blocks["w"].basis)


# ------------------------------------------------------- across packages ---

def _mixed(rng):
    """One tree with dicts, a list, a NamedTuple, None leaves, bf16 and
    an int leaf, as numpy arrays (bf16 values exactly representable)."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(torch.from_numpy(bf).bfloat16().float())
    return {"a": [rng.standard_normal((2, 3)).astype(np.float32),
                  Moments(m=rng.standard_normal(4).astype(np.float32),
                          v=None)],
            "b": {"bf": bf, "none": None,
                  "i": np.arange(5, dtype=np.int32)},
            "c": np.full((), 2.5, np.float32)}


def _jax_tree(t):
    return {"a": [jnp.asarray(t["a"][0]),
                  Moments(m=jnp.asarray(t["a"][1].m), v=None)],
            "b": {"bf": jnp.asarray(t["b"]["bf"], jnp.bfloat16),
                  "none": None, "i": jnp.asarray(t["b"]["i"])},
            "c": jnp.asarray(t["c"])}


def _torch_tree(t):
    return {"a": [torch.from_numpy(t["a"][0]),
                  Moments(m=torch.from_numpy(t["a"][1].m), v=None)],
            "b": {"bf": torch.from_numpy(t["b"]["bf"]).bfloat16(),
                  "none": None, "i": torch.from_numpy(t["b"]["i"])},
            "c": torch.from_numpy(t["c"])}


def test_files_and_keys_equal_jax(tmp_path):
    """The same tree saved by both packages gives the same file names,
    manifest and payload keys and values — ``a/1/.m`` for the NamedTuple
    field, bf16 as fp32."""
    t = _mixed(np.random.default_rng(0))
    jp = jckpt.save(str(tmp_path / "j"), 4, _jax_tree(t))
    tp = save(str(tmp_path / "t"), 4, _torch_tree(t))
    assert os.path.basename(jp) == os.path.basename(tp)
    with np.load(jp) as a, np.load(tp) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "a/0", "a/1/.m", "b/bf", "b/i", "c"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for d in ("j", "t"):
        with open(tmp_path / d / "ckpt_00000004.json") as f:
            text = f.read()
        assert text == open(tmp_path / "j" / "ckpt_00000004.json").read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_checkpoint(tmp_path, writer):
    t = _mixed(np.random.default_rng(1))
    jt, tt = _jax_tree(t), _torch_tree(t)
    if writer == "jax":
        jckpt.save(str(tmp_path), 2, jt, name="x")
        assert latest_step(str(tmp_path), name="x") == 2
        out = restore(str(tmp_path), 2, tt, name="x")
        for a, b in zip(tree.tree_leaves(out), tree.tree_leaves(tt)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert isinstance(out["a"][1], Moments) and out["a"][1].v is None
    else:
        save(str(tmp_path), 2, tt, name="x")
        assert jckpt.latest_step(str(tmp_path), name="x") == 2
        out = jckpt.restore(str(tmp_path), 2, jt, name="x")
        import jax
        for a, b in zip(jax.tree_util.tree_leaves(out),
                        jax.tree_util.tree_leaves(jt)):
            assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))
        assert out["a"][1].v is None


def test_numpy_and_scalar_templates(tmp_path):
    """A numpy template restores numpy arrays of its dtype (the
    client-state store's shards), a Python scalar its type (the GaLore
    step counter)."""
    t = {"rows": np.ones((2, 3), np.float32), "count": 7}
    save(str(tmp_path), 1, t)
    out = restore(str(tmp_path), 1, {"rows": np.zeros((2, 3), np.float32),
                                     "count": 0})
    assert isinstance(out["rows"], np.ndarray) and out["rows"].all()
    assert out["rows"].flags.writeable
    assert out["count"] == 7 and type(out["count"]) is int
