"""The port's checkpoint manager on the CPU: every case of
``tests/test_checkpoint.py`` (round trip, keep-N, latest, mismatched
structure, shape and dtype, a corrupt npz, metadata that disagrees with
the arrays, an unpublished ``.tmp-`` directory), the elastic restore onto
a mesh's positions, and the on-disk format against the JAX package's
manager: leaf order, ``tree.json``'s ``treedef``, checkpoints written by
one package and restored by the other, and bf16 leaves, which the port
restores bit for bit while the JAX manager refuses its own."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointError as JCheckpointError
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.dist import make_mesh


@pytest.fixture
def tmpdir(tmp_path):
    return str(tmp_path / "ckpt")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32)}}


def _meta_like(tree):
    return {k: _meta_like(v) for k, v in tree.items()} if isinstance(
        tree, dict) else torch.empty(tree.shape, dtype=tree.dtype,
                                     device="meta")


def _assert_trees_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


# a JAX-side tree: dict keys out of order at both levels, a tuple, a list,
# float32 and int32 leaves
def _jax_tree():
    k = jax.random.PRNGKey(3)
    return {"w": {"z": jax.random.normal(k, (3, 5)),
                  "b": jnp.arange(4, dtype=jnp.int32)},
            "m": (jnp.full((2,), 7.5), [jnp.arange(3, dtype=jnp.int32)]),
            "a": jnp.zeros((1, 2), jnp.float32)}


def _as_port(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), tree)


class TestCheckpoint:
    def test_roundtrip(self, tmpdir):
        mgr = CheckpointManager(tmpdir)
        t = _tree()
        mgr.save(10, t, extra={"cursor": 5})
        t2, extra = mgr.restore(10, t)
        assert extra["cursor"] == 5
        _assert_trees_equal(t2, t)

    def test_keep_n(self, tmpdir):
        mgr = CheckpointManager(tmpdir, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree())
        assert mgr.all_steps() == [3, 4]

    def test_latest(self, tmpdir):
        mgr = CheckpointManager(tmpdir)
        assert mgr.restore_latest(_tree()) is None
        mgr.save(7, _tree())
        step, _, _ = mgr.restore_latest(_tree())
        assert step == 7

    @pytest.mark.parametrize("bad,match", [
        # a missing leaf
        ({"a": torch.zeros((4, 8))}, "structure changed"),
        ({"a": torch.zeros((4, 9)),
          "b": {"c": torch.zeros((6,), dtype=torch.int32)}}, "shape"),
        # saved as int32: a float32 target is not a silent cast
        ({"a": torch.zeros((4, 8)),
          "b": {"c": torch.zeros((6,), dtype=torch.float32)}}, "dtype"),
    ], ids=["structure", "shape", "dtype"])
    def test_mismatch_rejected(self, tmpdir, bad, match):
        mgr = CheckpointManager(tmpdir)
        mgr.save(1, _tree())
        with pytest.raises(CheckpointError, match=match):
            mgr.restore(1, bad)

    def test_corrupt_npz_rejected(self, tmpdir):
        """A truncated/overwritten arrays.npz raises CheckpointError, not
        a zipfile traceback or silent garbage."""
        mgr = CheckpointManager(tmpdir)
        mgr.save(1, _tree())
        with open(os.path.join(tmpdir, "step_1", "arrays.npz"), "wb") as f:
            f.write(b"not a zip archive")
        with pytest.raises(CheckpointError):
            mgr.restore(1, _tree())

    def test_meta_array_disagreement_rejected(self, tmpdir):
        """tree.json is the integrity record: an arrays.npz whose leaves
        disagree with the metadata is refused even when it matches the
        restore target."""
        mgr = CheckpointManager(tmpdir)
        mgr.save(1, _tree())
        meta_path = os.path.join(tmpdir, "step_1", "tree.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["shapes"]["leaf_0"] = [2, 16]  # claim a different saved shape
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(CheckpointError, match="tree.json"):
            mgr.restore(1, _tree())

    def test_tmp_dir_not_published(self, tmpdir):
        """A stale .tmp dir (crash mid-save) must not be listed as a step."""
        mgr = CheckpointManager(tmpdir)
        os.makedirs(os.path.join(tmpdir, ".tmp-step_99"))
        assert mgr.all_steps() == []
        mgr.save(1, _tree())
        assert mgr.all_steps() == [1]

    def test_elastic_restore_onto_mesh_positions(self, tmpdir):
        """The counterpart of the JAX manager's ``shardings``: meta
        targets placed leaf by leaf on a two-position mesh's devices."""
        mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        t = _tree()
        CheckpointManager(tmpdir).save(1, t)
        devices = {"a": mesh.devices[0], "b": {"c": mesh.devices[1]}}
        t2, _ = CheckpointManager(tmpdir).restore(1, _meta_like(t),
                                                  devices=devices)
        _assert_trees_equal(t2, t)
        assert t2["a"].device == mesh.devices[0]
        with pytest.raises(ValueError, match="devices="):
            CheckpointManager(tmpdir).restore(1, _meta_like(t))


def test_treedef_and_leaf_order_match_jax(tmpdir):
    tree = _jax_tree()
    leaves, _ = jax.tree_util.tree_flatten(tree)
    CheckpointManager(tmpdir).save(1, _as_port(tree))
    with open(os.path.join(tmpdir, "step_1", "tree.json")) as f:
        meta = json.load(f)
    assert meta["treedef"] == str(jax.tree_util.tree_structure(tree))
    assert meta["n_leaves"] == len(leaves)
    with np.load(os.path.join(tmpdir, "step_1", "arrays.npz")) as data:
        for i, want in enumerate(leaves):
            np.testing.assert_array_equal(data[f"leaf_{i}"], np.asarray(want))
            assert meta["dtypes"][f"leaf_{i}"] == str(want.dtype)


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX checkpoint restores in the port leaf for leaf (into a target
    whose dicts were built in another order), and the port's in the JAX
    manager."""
    tree = _jax_tree()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(4, tree, extra={"loader": {"step": 4}})
    like = _as_port(tree)  # jax.tree_util.tree_map sorts the keys
    reordered = {"w": {"z": like["w"]["z"], "b": like["w"]["b"]},
                 "m": like["m"], "a": like["a"]}
    got, extra = CheckpointManager(jdir).restore(4, reordered)
    assert extra == {"loader": {"step": 4}}
    _assert_trees_equal(got, reordered)

    CheckpointManager(pdir).save(5, reordered, extra={"k": 1})
    back, extra = JCheckpointManager(pdir).restore(
        5, jax.eval_shape(lambda: tree))
    assert extra == {"k": 1}
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bf16_checkpoints_restore_in_port_not_in_jax(tmp_path):
    """Known state of the reference: ``np.savez`` stores a bf16 leaf as
    raw ``|V2`` words while ``tree.json`` records "bfloat16", and the JAX
    manager's dtype check then refuses its own checkpoint.  The port
    writes the same bytes and restores them bit for bit (its stated
    contract), from either package."""
    vals = jax.random.normal(jax.random.PRNGKey(1), (5, 3)).astype(
        jnp.bfloat16)
    tree = {"w": vals, "step": jnp.asarray(3, jnp.int32)}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointManager(jdir).save(1, tree)
    with pytest.raises(JCheckpointError, match="dtype"):
        JCheckpointManager(jdir).restore(1, jax.eval_shape(lambda: tree))

    like = {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    got, _ = CheckpointManager(jdir).restore(1, like)
    want_bits = np.asarray(vals).view(np.uint16)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy().view(np.uint16), want_bits)
    assert int(got["step"]) == 3

    CheckpointManager(pdir).save(1, got)
    for d in (jdir, pdir):
        with open(os.path.join(d, "step_1", "tree.json")) as f:
            assert json.load(f)["dtypes"]["leaf_1"] == "bfloat16"
        with np.load(os.path.join(d, "step_1", "arrays.npz")) as data:
            assert data["leaf_1"].dtype == np.dtype("V2")
            np.testing.assert_array_equal(
                data["leaf_1"].view(np.uint16), want_bits)
    again, _ = CheckpointManager(pdir).restore(1, like)
    assert torch.equal(again["w"].view(torch.int16),
                       got["w"].view(torch.int16))
    with pytest.raises(JCheckpointError, match="dtype"):
        JCheckpointManager(pdir).restore(1, jax.eval_shape(lambda: tree))


def test_cut_npz_refused_where_jax_raises_a_zipfile_error(tmp_path):
    """Known state of the reference: an arrays.npz cut after its zip
    header escapes the JAX manager as ``zipfile.BadZipFile``, against its
    own contract (a corrupt npz raises CheckpointError); the port keeps
    the contract."""
    import zipfile

    for mgr_cls, like, raises in (
            (JCheckpointManager, {"a": jnp.ones(3)}, zipfile.BadZipFile),
            (CheckpointManager, {"a": torch.ones(3)}, CheckpointError)):
        d = str(tmp_path / mgr_cls.__module__)
        mgr_cls(d).save(1, like)
        path = os.path.join(d, "step_1", "arrays.npz")
        with open(path, "rb") as f:
            head = f.read(64)
        with open(path, "wb") as f:
            f.write(head)
        with pytest.raises(raises):
            mgr_cls(d).restore(1, like)
