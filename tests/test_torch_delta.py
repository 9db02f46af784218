"""The port's incremental delta sweep (``repro_torch/core/delta.py``) and the
emitters' delta rules, held against the JAX package's (``repro.core.delta``,
numpy on the host, imported in-process).

  * the schedule — ``dirty_tiles``, ``owner_partition`` and ``delta_rounds``
    — is identical to the reference's for every registered placement,
    P in ``DELTA_P`` and every engine mode;
  * within the port, ``DeltaIndex`` is bit-exact to ``scratch_fold`` after
    every update (the churn differential contract);
  * against the reference's ``DeltaIndex`` on the same updates: the dense
    total within rtol 1e-6 (another product and summation order), the
    join's pair set and the k-NN ids equal;
  * the emitter hooks on tensors equal the reference's on numpy;
  * the schedule properties of ``tests/test_delta_properties.py`` with
    hypothesis.
"""

import numpy as np
import pytest
import torch

from repro.core import delta as r_delta
from repro.core import faults as r_faults
from repro.core.allpairs import DenseReduceEmitter as RDense
from repro.core.knn import KnnEmitter as RKnn
from repro.core.placement import get_placement as r_get_placement
from repro.core.sparse import ThresholdJoinEmitter as RJoin
from repro_torch.core.allpairs import DenseReduceEmitter
from repro_torch.core.delta import (DELTA_P, DeltaIndex, churn_selfcheck,
                                    churn_workload, delta_rounds, delta_sweep,
                                    dirty_tiles, owner_partition,
                                    random_update, scratch_fold)
from repro_torch.core.faults import (DenseReduceWorkload, KnnGraphWorkload,
                                     SparseJoinWorkload, WORKLOADS)
from repro_torch.core.knn import KnnEmitter
from repro_torch.core.placement import (get_placement, registered_placements,
                                        weighted_owner_table)
from repro_torch.core.scheduler import reassign
from repro_torch.core.sparse import ThresholdJoinEmitter
from repro_torch.core.sweep import ENGINE_MODES, SweepEmitter, sweep_rounds

R_WORKLOADS = dict(zip(("dense", "sparse", "knn"), r_faults.WORKLOADS))
SENT = np.iinfo(np.int64).max


def _placements(P):
    return [name for name, cls in sorted(registered_placements().items())
            if cls.supports(P)]


def _supported_P(name):
    cls = registered_placements()[name]
    return next(P for P in (8, 7, 12, 5) if cls.supports(P))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the schedule, identical to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", DELTA_P)
def test_schedule_matches_reference(P):
    """dirty_tiles / owner_partition / delta_rounds equal the reference's
    for every registered placement, several dirty sets and every mode."""
    rng = np.random.RandomState(P)
    dirty_sets = [[0], [P - 1], sorted(rng.choice(P, 2, replace=False)),
                  list(range(P))]
    for name in _placements(P):
        plc, rplc = get_placement(name, P), r_get_placement(name, P)
        assert owner_partition(plc) == r_delta.owner_partition(rplc)
        for dirty in dirty_sets:
            tiles = dirty_tiles(plc, dirty)
            assert tiles == r_delta.dirty_tiles(rplc, dirty)
            for mode in ENGINE_MODES:
                assert (delta_rounds(plc, tiles, mode)
                        == r_delta.delta_rounds(rplc, tiles, mode)), (
                    name, dirty, mode)


def test_weighted_owner_partition_matches_reference():
    P = 8
    weights = [4.0 if i == 0 else 1.0 + (i % 3) for i in range(P)]
    assert (owner_partition(get_placement("cyclic", P), weights=weights)
            == r_delta.owner_partition(r_get_placement("cyclic", P),
                                       weights=weights))


@pytest.mark.parametrize("P,dirty", [
    (5, [0]), (7, [1, 4]), (8, [7]), (13, [0, 6, 12]), (4, [0, 1, 2, 3]),
])
def test_dirty_tiles_covers_exactly_dirty_endpoints(P, dirty):
    tiles = dirty_tiles(None, dirty, P=P)
    D = set(dirty)
    assert set(tiles) == {(x, y) for x in range(P) for y in range(x, P)
                          if x in D or y in D}
    assert tiles == sorted(tiles)
    d = len(D)
    assert len(tiles) == d * P - d * (d - 1) // 2 <= d * P


def test_dirty_tiles_validates():
    with pytest.raises(ValueError, match="placement or an explicit P"):
        dirty_tiles(None, [0])
    with pytest.raises(ValueError, match="outside"):
        dirty_tiles(None, [5], P=5)
    with pytest.raises(ValueError, match="outside"):
        dirty_tiles(None, [-1], P=5)
    assert dirty_tiles(None, [], P=5) == []
    for P in (1, 2, 5):
        assert len(dirty_tiles(None, range(P), P=P)) == P * (P + 1) // 2


@pytest.mark.parametrize("name", sorted(registered_placements()))
def test_owner_partition_exactly_once_and_coresident(name):
    P = _supported_P(name)
    plc = get_placement(name, P)
    owners = owner_partition(plc)
    assert set(owners) == {(x, y) for x in range(P) for y in range(x, P)}
    for (x, y), o in owners.items():
        assert x in plc.residency_sets[o] and y in plc.residency_sets[o]


def test_owner_partition_weighted_matches_table():
    P = 8
    plc = get_placement("cyclic", P)
    weights = [4.0 if i == 0 else 1.0 for i in range(P)]
    table = weighted_owner_table(plc, weights)
    for (x, y), o in owner_partition(plc, weights=weights).items():
        assert o == int(table[x, y])


@pytest.mark.parametrize("P", [4, 5, 8, 13])
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_delta_rounds_partition_tiles(P, mode):
    plc = get_placement("cyclic", P)
    tiles = dirty_tiles(plc, [0, P - 1])
    rounds = delta_rounds(plc, tiles, mode)
    assert sorted(t for grp in rounds for t in grp) == sorted(tiles)
    assert all(grp and grp == sorted(grp) for grp in rounds)
    if mode == "batched":
        assert len(rounds) == 1
    if mode == "scan":
        assert rounds == [[t] for t in sorted(tiles)]
    if mode != "scan":
        assert len(rounds) <= len(sweep_rounds(plc.schedule(), mode))
    with pytest.raises(ValueError, match="mode"):
        delta_rounds(plc, tiles, "auto")


# ---------------------------------------------------------------------------
# the emitter delta rules, on tensors, against the reference's on numpy
# ---------------------------------------------------------------------------

def test_base_emitter_has_no_delta_rule():
    with pytest.raises(NotImplementedError, match="delta_retract"):
        SweepEmitter.delta_retract(0.0, 0.0)
    with pytest.raises(NotImplementedError, match="delta_fold"):
        SweepEmitter.delta_fold(0.0, 0.0)


def test_dense_emitter_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(5):
        a, b, c = rng.randn(3) * 100
        got = DenseReduceEmitter.delta_fold(
            DenseReduceEmitter.delta_retract(torch.tensor(a), b), c)
        want = RDense.delta_fold(RDense.delta_retract(np.float64(a), b), c)
        assert got.dtype == torch.float64 and float(got) == float(want)


def test_join_emitter_matches_reference():
    standing = np.array([[0, 1], [2, 5], [3, 4]], np.int64)
    stale = np.array([[2, 5]], np.int64)
    ins = np.array([[2, 6], [0, 9]], np.int64)
    empty = np.zeros((0, 2), np.int64)
    got = ThresholdJoinEmitter.delta_retract(torch.as_tensor(standing),
                                             torch.as_tensor(stale))
    want = RJoin.delta_retract(standing, stale)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ThresholdJoinEmitter.delta_fold(got, torch.as_tensor(ins)).numpy(),
        RJoin.delta_fold(want, ins))
    assert ThresholdJoinEmitter.delta_retract(
        torch.as_tensor(standing), empty).tolist() == standing.tolist()
    assert ThresholdJoinEmitter.delta_retract(empty, stale).shape == (0, 2)
    # a random hit set
    rng = np.random.RandomState(1)
    rows = np.unique(rng.randint(0, 40, (60, 2)), axis=0)
    rows = rows[rows[:, 0] < rows[:, 1]]
    st, gone, fresh = rows[::2], rows[::6], rng.randint(40, 80, (9, 2))
    np.testing.assert_array_equal(
        ThresholdJoinEmitter.delta_fold(
            ThresholdJoinEmitter.delta_retract(st, gone), fresh).numpy(),
        RJoin.delta_fold(RJoin.delta_retract(st, gone), fresh))


def test_knn_emitter_merge_is_rowwise_topk():
    s1 = np.array([[3.0, 1.0], [5.0, -np.inf]], np.float32)
    i1 = np.array([[7, 9], [2, SENT]], np.int64)
    s2 = np.array([[2.0, 3.0], [5.0, 6.0]], np.float32)
    i2 = np.array([[8, 4], [1, 0]], np.int64)
    ms, mi = KnnEmitter.delta_fold(
        (torch.as_tensor(s1), torch.as_tensor(i1)),
        (torch.as_tensor(s2), torch.as_tensor(i2)))
    assert ms[0].tolist() == [3.0, 3.0] and mi[0].tolist() == [4, 7]
    assert ms[1].tolist() == [6.0, 5.0] and mi[1].tolist() == [0, 1]


def test_knn_emitter_matches_reference_on_ties():
    """Random lists with many tied scores, -0.0 / 0.0 and sentinels."""
    rng = np.random.RandomState(2)
    n, k = 40, 4
    s = [rng.randint(-3, 4, (n, k)).astype(np.float32) for _ in range(2)]
    s[0][0, 0], s[1][0, 1] = -0.0, 0.0
    i = [rng.permutation(1000)[:2 * n * k].reshape(2, n, k)[j]
         .astype(np.int64) for j in range(2)]
    s[1][3], i[1][3] = -np.inf, SENT
    got = KnnEmitter.delta_fold((torch.as_tensor(s[0]), torch.as_tensor(i[0])),
                                (torch.as_tensor(s[1]), torch.as_tensor(i[1])))
    want = RKnn.delta_fold((s[0], i[0]), (s[1], i[1]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    starts, stops = np.array([10, 500]), np.array([40, 700])
    np.testing.assert_array_equal(
        KnnEmitter.delta_retract((None, torch.as_tensor(i[0])),
                                 (starts, stops)).numpy(),
        RKnn.delta_retract((None, i[0]), (starts, stops)))


def test_knn_emitter_retract_flags_citing_rows():
    best_i = torch.tensor([[0, 5], [9, 3], [7, 8]])
    mask = KnnEmitter.delta_retract((None, best_i), ([4], [6]))
    assert mask.tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# delta_sweep and DeltaIndex in the port: bit-exact to scratch_fold
# ---------------------------------------------------------------------------

def _equal_partial(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("wl_cls", WORKLOADS, ids=lambda c: c.name)
def test_delta_sweep_partials_match_direct(wl_cls):
    P = 7
    plc = get_placement("projective", P)
    wl = wl_cls(P, seed=1, device="cpu")
    fresh = delta_sweep(wl, plc, [3], mode="overlap")
    assert set(fresh) == set(dirty_tiles(plc, [3]))
    for (x, y), part in fresh.items():
        assert _equal_partial(
            part, wl.pair_partial(x, y, wl.blocks[x], wl.blocks[y]))


@pytest.mark.parametrize("wl_cls", WORKLOADS, ids=lambda c: c.name)
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_delta_index_bit_exact_under_updates(wl_cls, mode):
    P = 7
    plc = get_placement("projective", P)
    wl = churn_workload(wl_cls, P, seed=3, device="cpu")
    index = DeltaIndex(wl, plc, mode=mode)
    assert wl.equal(index.result, scratch_fold(wl))
    rng = np.random.RandomState(11)
    dim = wl.blocks[0].shape[1]
    for b, rows in ((2, wl.blocks[2].shape[0]), (4, 1),
                    (4, index.span_of(4))):
        index.replace_block(b, rng.randn(rows, dim).astype(np.float32))
        out = index.apply()
        assert index.stats.last_tiles <= P
        assert wl.equal(out, scratch_fold(wl))
    index.replace_block(0, rng.randn(2, dim).astype(np.float32))
    index.replace_block(6, torch.randn(2, dim))
    out = index.apply()
    assert index.stats.last_tiles == 2 * P - 1
    assert wl.equal(out, scratch_fold(wl))
    assert index.stats.updates == 4


def test_delta_index_counters_and_fallbacks(monkeypatch):
    P = 8
    plc = get_placement("cyclic", P)
    rng = np.random.RandomState(4)
    dense = DeltaIndex(churn_workload(DenseReduceWorkload, P, seed=5,
                                      device="cpu"), plc)
    for b in (1, 6, 3):
        dense.replace_block(b, rng.randn(2, 8).astype(np.float32))
        out = dense.apply()
        np.testing.assert_allclose(float(dense._running_total), float(out),
                                   rtol=1e-9)
        assert dense.workload.equal(out, scratch_fold(dense.workload))
    knn = DeltaIndex(churn_workload(KnnGraphWorkload, P, seed=2,
                                    device="cpu"), plc)
    knn.replace_block(3, rng.randn(2, 8).astype(np.float32))
    assert knn.workload.equal(knn.apply(), scratch_fold(knn.workload))
    assert knn.stats.rows_refreshed > 0 and knn.stats.rows_merged > 0
    join = DeltaIndex(churn_workload(SparseJoinWorkload, P, seed=2,
                                     device="cpu"), plc)
    join.replace_block(0, rng.randn(2, 8).astype(np.float32))
    assert join.workload.equal(join.apply(), scratch_fold(join.workload))
    assert join.stats.hits_retracted + join.stats.hits_inserted > 0
    # listener form, no-op apply, full-rebuild fallback and its knob
    wl = churn_workload(DenseReduceWorkload, 5, seed=7, device="cpu")
    index = DeltaIndex(wl, get_placement("cyclic", 5), max_dirty_pct=0)
    assert index.apply() is index.result and index.stats.updates == 0
    wl.blocks[2] = torch.randn(wl.blocks[2].shape)
    index.mark_dirty(2)
    assert wl.equal(index.apply(), scratch_fold(wl))
    assert index.stats.full_rebuilds == 1
    assert index.stats.last_tiles == index.stats.tiles_full == 15
    with pytest.raises(ValueError, match="outside"):
        index.mark_dirty(5)
    monkeypatch.setenv("REPRO_DELTA_MAX_DIRTY_PCT", "150")
    with pytest.raises(ValueError, match="max_dirty_pct"):
        DeltaIndex(wl, get_placement("cyclic", 5))


def test_delta_index_validates_inputs():
    P = 5
    plc = get_placement("cyclic", P)
    wl = churn_workload(DenseReduceWorkload, P, seed=0, device="cpu")
    index = DeltaIndex(wl, plc)
    with pytest.raises(ValueError, match="mode"):
        DeltaIndex(wl, plc, mode="auto")
    with pytest.raises(ValueError, match="P="):
        DeltaIndex(churn_workload(DenseReduceWorkload, 4, device="cpu"), plc)
    with pytest.raises(ValueError, match="at most"):
        index.replace_block(0, np.zeros((index.span_of(0) + 1, 8),
                                        np.float32))
    with pytest.raises(ValueError, match="block data"):
        index.replace_block(0, np.zeros((1, 9), np.float32))
    with pytest.raises(ValueError, match="outside"):
        index.span_of(P)
    with pytest.raises(ValueError, match="spare"):
        churn_workload(DenseReduceWorkload, P, spare=-1, device="cpu")


def test_churn_workload_matches_reference_geometry():
    for wl_cls in WORKLOADS:
        wl = churn_workload(wl_cls, 5, seed=0, spare=2, device="cpu")
        ref = r_delta.churn_workload(R_WORKLOADS[wl_cls.name], 5, seed=0,
                                     spare=2)
        assert (wl.offsets, wl.n) == (ref.offsets, ref.n)
        for a, b in zip(wl.blocks, ref.blocks):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("P,modes", [(5, ("batched",)),
                                     (4, ("overlap", "scan"))])
def test_churn_selfcheck_small_slice(P, modes):
    n = churn_selfcheck(Ps=(P,), modes=modes, placements=("cyclic",),
                        n_updates=2, verbose=False, device="cpu")
    assert n == 3 * len(modes)


def test_churn_selfcheck_env_knobs(monkeypatch):
    monkeypatch.setenv("REPRO_DELTA_UPDATES", "1")
    monkeypatch.setenv("REPRO_DELTA_SEED", "9")
    assert churn_selfcheck(Ps=(4,), modes=("batched",),
                           placements=("cyclic",), verbose=False,
                           device="cpu") == 3
    monkeypatch.setenv("REPRO_DELTA_UPDATES", "zero")
    with pytest.raises(ValueError, match="REPRO_DELTA_UPDATES"):
        churn_selfcheck(Ps=(4,), modes=("batched",), placements=("cyclic",),
                        verbose=False, device="cpu")


def test_delta_constants_and_cli(capsys):
    from repro_torch.core import delta
    assert DELTA_P == r_delta.DELTA_P
    assert delta._main(["--P", "5", "--modes", "scan", "--placements",
                        "cyclic", "--updates", "1", "--device", "cpu"]) == 0
    assert "churn selfcheck OK (3 cases" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the reference's DeltaIndex on the same updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,name", [(5, "cyclic"), (7, "projective"),
                                    (8, "cyclic")])
@pytest.mark.parametrize("wl_name", ["dense", "sparse", "knn"])
def test_delta_index_matches_reference(P, name, wl_name):
    """Five random replace / append updates (the reference's draws, one
    with two dirty blocks) through both packages' DeltaIndex."""
    wl_cls = {c.name: c for c in WORKLOADS}[wl_name]
    wl = churn_workload(wl_cls, P, seed=1, device="cpu")
    rwl = r_delta.churn_workload(R_WORKLOADS[wl_name], P, seed=1)
    index = DeltaIndex(wl, get_placement(name, P), mode="overlap")
    rindex = r_delta.DeltaIndex(rwl, r_get_placement(name, P),
                                mode="overlap")
    rng = np.random.RandomState(P)
    for u in range(5):
        for _ in range(2 if u == 3 else 1):
            b, data = random_update(wl, rng, index.span_of)
            index.replace_block(b, data)
            rindex.replace_block(b, data.numpy())
        got, want = index.apply(), rindex.apply()
        assert index.stats.last_tiles == rindex.stats.last_tiles
        assert wl.equal(got, scratch_fold(wl))
        if wl_name == "dense":
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        else:
            np.testing.assert_array_equal(_np(got), want)
    if wl_name == "knn":
        assert index.stats.rows_refreshed == rindex.stats.rows_refreshed
        assert index.stats.rows_merged == rindex.stats.rows_merged


# ---------------------------------------------------------------------------
# plan stability: the contract shared with failure recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cyclic", "projective"])
def test_reassign_plan_stable_over_dirty_tiles(name):
    P = 13
    plc = get_placement(name, P)
    owners = owner_partition(plc)
    pending = [t for t in dirty_tiles(plc, plc.residency_sets[2])
               if owners[t] == 2]
    assert pending
    plans = [reassign(plc.schedule(), [2], placement=plc,
                      pairs={2: list(pending)}) for _ in range(2)]
    assert plans[0] == plans[1]
    replayed = {t for ps in plans[0].extra_pairs.values() for t in ps}
    replayed |= {t for es in plans[0].fetch_pairs.values()
                 for (t, _b, _s) in es}
    assert replayed == set(pending)


@pytest.mark.parametrize("name", sorted(registered_placements()))
def test_residency_universe_contains_owned_tiles(name):
    P = _supported_P(name)
    plc = get_placement(name, P)
    owners = owner_partition(plc)
    for d in range(P):
        universe = set(dirty_tiles(plc, plc.residency_sets[d]))
        assert {t for t, o in owners.items() if o == d} <= universe


# ---------------------------------------------------------------------------
# schedule properties (tests/test_delta_properties.py's, on the port)
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@st.composite
def dirty_case(draw, max_P=16):
    P = draw(st.integers(min_value=1, max_value=max_P))
    dirty = draw(st.sets(st.integers(min_value=0, max_value=P - 1),
                         max_size=P))
    return P, dirty


@given(dirty_case())
@settings(max_examples=60, deadline=None)
def test_prop_schedule_covers_exactly_dirty_endpoint_pairs(case):
    P, dirty = case
    tiles = dirty_tiles(None, dirty, P=P)
    assert tiles == r_delta.dirty_tiles(None, dirty, P=P)
    assert set(tiles) == {(x, y) for x in range(P) for y in range(x, P)
                          if x in dirty or y in dirty}
    assert len(tiles) == len(set(tiles)) and tiles == sorted(tiles)


@given(dirty_case())
@settings(max_examples=60, deadline=None)
def test_prop_tile_count_formula_and_bound(case):
    P, dirty = case
    n, d = len(dirty_tiles(None, dirty, P=P)), len(dirty)
    assert n == d * P - d * (d - 1) // 2 <= d * P
    if 0 < d < P / 2:
        assert n < P * (P + 1) // 2
    if d == P:
        assert n == P * (P + 1) // 2


@given(st.integers(min_value=1, max_value=16))
@settings(max_examples=40, deadline=None)
def test_prop_ownership_partitions_exactly_once(P):
    plc = get_placement("cyclic", P)
    owners = owner_partition(plc)
    assert owners == r_delta.owner_partition(r_get_placement("cyclic", P))
    assert set(owners) == {(x, y) for x in range(P) for y in range(x, P)}
    for (x, y), o in owners.items():
        assert x in plc.residency_sets[o] and y in plc.residency_sets[o]


@given(dirty_case(max_P=13), st.sampled_from(ENGINE_MODES))
@settings(max_examples=60, deadline=None)
def test_prop_rounds_partition_the_schedule(case, mode):
    P, dirty = case
    plc = get_placement("cyclic", P)
    tiles = dirty_tiles(plc, dirty)
    rounds = delta_rounds(plc, tiles, mode)
    assert rounds == r_delta.delta_rounds(r_get_placement("cyclic", P),
                                          tiles, mode)
    assert sorted(t for grp in rounds for t in grp) == sorted(tiles)
    assert all(grp for grp in rounds)
    if mode == "scan":
        assert all(len(grp) == 1 for grp in rounds)
    if mode == "batched" and tiles:
        assert len(rounds) == 1
