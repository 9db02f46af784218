"""The port's checkpoint store (``repro_torch/ckpt/checkpoint.py``): round
trips of tensor trees onto the caller's device (dtypes from the target
structure, bf16 through its lossless f32 upcast), the atomic-commit
manifest rule, latest-valid resume, the async manager, and files that
read the same in both packages (the reference, ``repro.ckpt``, imported
in-process).  The reference's ``test_rescale_restore`` fails on jax 0.9
(ROADMAP C.4); its counterpart here holds a restore under a new P against
a numpy oracle: the stored global corpus re-chunked by the plan of
``repro_torch.launch.elastic.rescale``."""

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              load_checkpoint, load_named_tree,
                              restore_or_none, save_checkpoint)
from repro_torch.launch.elastic import rescale


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(12, 4, generator=g),
                   "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "step": np.int32(seed),
        "ids": torch.arange(5, dtype=torch.int64) * seed,
        "scales": [np.random.default_rng(seed).uniform(size=(3,))
                   .astype(np.float32), torch.full((2, 2), float(seed))],
        "pair": (torch.tensor(seed, dtype=torch.float64), None),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _assert_tree_equal(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x) is type(y) or isinstance(y, np.generic)
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_onto_the_callers_device(tmp_path):
    tree = _tree(3)
    path = save_checkpoint(tmp_path, 7, tree)
    assert path == tmp_path / "step_7" and (path / "MANIFEST.json").exists()
    restored, step = load_checkpoint(tmp_path, _tree(0))
    assert step == 7
    _assert_tree_equal(restored, tree)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert isinstance(restored["pair"], tuple) and restored["pair"][1] is None
    # an explicit device overrides the template's
    moved, _ = load_checkpoint(tmp_path, _tree(0), device="cpu")
    assert moved["params"]["w"].device.type == "cpu"


def test_latest_step_requires_manifest(tmp_path):
    assert latest_step(tmp_path) is None
    assert latest_step(tmp_path / "missing") is None
    save_checkpoint(tmp_path, 1, _tree(1))
    save_checkpoint(tmp_path, 5, _tree(5))
    torn = tmp_path / "step_9"            # a crash mid-write: no manifest
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"torn write")
    assert latest_step(tmp_path) == 5
    restored, step = load_checkpoint(tmp_path, _tree(0))
    assert step == 5
    _assert_tree_equal(restored, _tree(5))
    older, _ = load_checkpoint(tmp_path, _tree(0), step=1)
    _assert_tree_equal(older, _tree(1))
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        load_checkpoint(tmp_path / "empty", _tree(0))


def test_named_tree_and_restore_or_none(tmp_path):
    assert restore_or_none(tmp_path) is None
    save_checkpoint(tmp_path, 2, _tree(2))
    tree, step = restore_or_none(tmp_path)
    assert step == 2 and isinstance(tree["params"]["w"], np.ndarray)
    np.testing.assert_array_equal(tree["params"]["w"],
                                  _tree(2)["params"]["w"].numpy())
    assert set(tree["scales"]) == {"0", "1"}
    on_dev, _ = load_named_tree(tmp_path, device="cpu")
    assert torch.equal(on_dev["ids"], _tree(2)["ids"])


def test_files_read_the_same_in_both_packages(tmp_path):
    """The leaf names are the reference's "/"-joined paths: a file either
    package writes, the other's named-tree loader reads."""
    tree = {"blocks": {"0": torch.ones(2, 3), "1": torch.zeros(1, 3)},
            "round": np.int64(4), "partials": {"0_1": {"v": torch.tensor(
                2.5, dtype=torch.float64)}}}
    save_checkpoint(tmp_path / "port", 4, tree)
    ref_tree, step = r_ckpt.load_named_tree(tmp_path / "port")
    assert step == 4 and int(ref_tree["round"]) == 4
    np.testing.assert_array_equal(ref_tree["blocks"]["1"], np.zeros((1, 3)))
    assert float(ref_tree["partials"]["0_1"]["v"]) == 2.5
    r_ckpt.save_checkpoint(tmp_path / "ref", 6, {
        "w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "s": [np.float64(1.5), np.int32(7)]})
    got, step = load_checkpoint(tmp_path / "ref", {
        "w": torch.zeros(2, 3), "s": [torch.zeros(()), np.int32(0)]})
    assert step == 6 and torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert got["s"][0].dtype == torch.float32 and float(got["s"][0]) == 1.5
    assert int(got["s"][1]) == 7


def test_manager_async_gc_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        tree = _tree(s)
        mgr.save_async(s, tree)
        tree["params"]["w"].add_(100.0)   # the snapshot was taken already
        mgr.wait()
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_3", "step_4"]
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 4
    _assert_tree_equal(restored, _tree(4))


def test_manager_surfaces_async_errors(tmp_path, monkeypatch):
    import repro_torch.ckpt.checkpoint as ck
    mgr = CheckpointManager(tmp_path / "sub", keep=2)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_checkpoint", boom)
    mgr.save_async(1, _tree(1))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save_async(2, _tree(2))
    mgr.wait()
    assert latest_step(tmp_path / "sub") == 2


@pytest.mark.parametrize("P_old,P_new", [(4, 6), (4, 8), (8, 4), (12, 12)])
def test_rescale_restore(tmp_path, P_old, P_new):
    """A corpus stored under P_old restores bit for bit, and every device's
    new residency under P_new materializes from it: the numpy oracle is
    the corpus re-chunked into P_new equal blocks."""
    N, d = 48, 8
    corpus = np.random.default_rng(1).normal(size=(N, d)).astype(np.float32)
    save_checkpoint(tmp_path, 3, {"corpus": torch.from_numpy(corpus)
                                  .reshape(P_old, N // P_old, d)})
    plan = rescale(P_old, P_new)
    restored, step = load_checkpoint(tmp_path, {"corpus": torch.zeros(
        P_old, N // P_old, d)})
    assert step == 3
    flat = restored["corpus"].reshape(N, d)
    np.testing.assert_array_equal(flat.numpy(), corpus)
    blocks = flat.reshape(P_new, N // P_new, d)
    for res in plan.new_quorums:
        for b in res:
            np.testing.assert_array_equal(
                blocks[b].numpy(), np.split(corpus, P_new)[b])
    if P_old == P_new:
        assert plan.fetches == {}
    elif P_new % P_old and P_old % P_new:
        assert plan.fetches == {i: list(q)
                                for i, q in enumerate(plan.new_quorums)}
