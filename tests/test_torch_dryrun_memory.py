"""The dry run's memory, cost and collectives (``repro_torch/launch/
meta_trace.py``, ``launch/dryrun.py``'s ``run_cell``) on the CPU.

(i) ``StepTrace``'s live bytes and peak on a hand-counted graph, and a
backward formula's write into its zeros in place; (ii) each
hand-written kernel's meta route allocates the outputs and scratch its
CUDA route allocates, by shape and dtype, and launches nothing; (iii) the
accumulation search at a small budget; (iv) a record's keys are the
reference's ``run_cell`` keys; (v) ``cost.flops`` of a one-layer dense
step equals a count by hand, and B9's and B10's operation counts equal
counts pair by pair; (vi) the trace with and without its kept shapes
gives the same record, in train, prefill and decode steps; (vii) ``CountingComm``'s groups and the
tensor-parallel plan on the five meshes of tests/test_torch_tp_plan.py.
The counting comm against real gloo ranks' counters is in
tests/test_torch_distributed_{train,decode}.py."""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import dryrun as r_dryrun
from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import PORTED, Shape
from repro_torch.kernels import _build, flash_attention as fa, ops
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.launch import dryrun, meta_trace, mesh as t_mesh, steps

META = dict(device="meta")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Allocations(TorchDispatchMode):
    """(shape, dtype) of every tensor a call allocates (``empty``-family
    operations), in order."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.empty.memory_format,
                    torch.ops.aten.empty_strided.default,
                    torch.ops.aten.empty_like.default):
            self.made.append((tuple(out.shape), out.dtype))
        return out


def allocations(fn):
    with Allocations() as mode:
        out = fn()
    return mode.made, out


def test_tracker_peak_on_a_hand_counted_graph():
    """Arguments held throughout; a new storage adds its bytes, a view
    none, a freed one takes them off; 512-byte blocks; in-place writes to
    an argument are noted."""
    a = torch.empty(1000, **META)                  # 4,000 bytes, held
    b = torch.empty(10, dtype=torch.int32, **META)  # 40 bytes, held

    def step(a, b):
        x = a * 2                                  # +4,000
        v = x[:500]                                # a view: +0
        y = v + 1                                  # +2,000 -> 10,040
        del x, v                                   # -4,000
        z = y.sum()                                # +4 -> 6,044
        a.mul_(3)                                  # writes argument a
        return {"z": z}

    got = meta_trace.trace(step, (a, b))
    assert got["held"] == 4040
    assert got["peak"] == 4040 + 4000 + 2000
    assert got["peak_blocks"] == 4096 + 512 + 4096 + 2048
    assert got["written"] == 4000
    assert got["returned"] == 4


def test_tracker_frees_autograd_temporaries():
    """A backward's saved tensors die with the graph: the live sum comes
    back to the arguments plus the gradient."""
    w = torch.empty(64, 64, **META)

    def step(w):
        w = w.requires_grad_(True)
        x = torch.empty(8, 64, **META)
        loss = torch.tanh(x @ w).sum()
        (g,) = torch.autograd.grad(loss, [w])
        w.requires_grad_(False)
        return g

    mode = meta_trace.StepTrace(cost=False)
    held = mode.hold((w,))
    with mode:
        g = step(w)
    assert mode.live == held + g.numel() * 4
    assert mode.peak > mode.live


@pytest.mark.parametrize("op", ["gather", "index", "index_select",
                                "max"])
def test_backward_writes_into_its_zeros_in_place(op, monkeypatch):
    """These backward formulas make zeros of the input's shape and write
    the gradient into them in place; under a dispatch mode autograd calls
    the functional overload instead (a second buffer of that size), which
    the trace runs in place as the step runs without the mode."""
    x = torch.empty(64, 1000, **META)              # 256,000 bytes, held
    idx = torch.zeros(64, 3, dtype=torch.int64, **META)
    rows = torch.zeros(5, dtype=torch.int64, **META)

    def step(x, idx, rows):
        x.requires_grad_(True)
        y = {"gather": lambda: torch.gather(x, 1, idx),
             "index": lambda: x[rows],
             "index_select": lambda: torch.index_select(x, 0, rows),
             "max": lambda: x.max(dim=1).values}[op]()
        (g,) = torch.autograd.grad(y.sum(), [x])
        x.requires_grad_(False)
        return g

    peaks = []
    for table in (meta_trace._IN_PLACE, {}):
        monkeypatch.setattr(meta_trace, "_IN_PLACE", table)
        got = meta_trace.trace(step, (x, idx, rows), cost=False)
        assert got["returned"] == 256_000
        peaks.append(got["peak"])
    assert peaks[1] - peaks[0] == 256_000


def _b9(B, Tq, Tk, H, KV, hd, dtype):
    q = torch.empty(B, Tq, H, hd, dtype=dtype, **META)
    k = torch.empty(B, Tk, KV, hd, dtype=dtype, **META)
    return q, k, torch.empty_like(k)


@pytest.mark.parametrize("mode", ["plain", "lse", "partial"])
def test_b9_meta_route_allocates_its_outputs(mode):
    q, k, v = _b9(2, 96, 96, 4, 2, 64, torch.bfloat16)
    before = fa.launches
    made, out = allocations(lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, with_lse=mode == "lse",
        partial=mode == "partial",
        row_valid=torch.ones(2, **META) if mode == "partial" else None))
    o = (2, 96, 4, 64)
    want = {"plain": [(o, torch.bfloat16)],
            "lse": [(o, torch.bfloat16), ((2, 96, 4), torch.float32)],
            "partial": [(o, torch.float32), ((2, 96, 4), torch.float32),
                        ((2, 96, 4), torch.float32)]}[mode]
    assert made[:len(want)] == want
    assert fa.launches == before
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t.device.type == "meta" for t in outs)


@pytest.mark.parametrize("dtype,hd,Tk", [(torch.bfloat16, 64, 256),
                                         (torch.bfloat16, 128, 4096),
                                         (torch.float32, 64, 256),
                                         (torch.bfloat16, 256, 256)])
def test_b9_bwd_meta_route_allocates_its_route_scratch(dtype, hd, Tk):
    B, H, KV = 2, 8, 2
    q, k, v = _b9(B, Tk, Tk, H, KV, hd, dtype)
    o, do = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(B, Tk, H, dtype=torch.float32, **META)
    before = fa.bwd_launches
    made, (dq, dk, dv) = allocations(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=True))
    want = [(tuple(q.shape), dtype), (tuple(k.shape), dtype),
            (tuple(v.shape), dtype)]
    f32 = torch.float32
    if fa.bwd_route_of(dtype, hd) == "wgmma":
        plan = fa.bwd_plan(B, Tk, Tk, H, KV, hd, True, sms=fa.SMS)
        TqP = plan.nqt * plan.bq
        want += [((B, H, TqP), f32), ((B, H, TqP), f32),
                 ((B, H, TqP, plan.hdp), f32),
                 ((B, H, plan.nqt), torch.int32)]
        want += [((plan.slices, B, Tk, KV, hd), f32)] * 2 * (
            plan.slices > 1)
    else:
        want += [((B, Tk, H), f32)]
    assert made == want
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert fa.bwd_launches == before


@pytest.mark.parametrize("with_dS", [True, False])
def test_b10_meta_routes_allocate_their_outputs_and_scratch(with_dS):
    Bsz, T, H, P, N, L = 2, 512, 24, 64, 128, 256
    f32 = torch.float32
    x = torch.empty(Bsz, T, H, P, **META)
    dt = torch.empty(Bsz, T, H, **META)
    A = torch.empty(H, **META)
    Bm, Cm = torch.empty(Bsz, T, N, **META), torch.empty(Bsz, T, N, **META)
    nc = T // L
    before = (sc.launches, sc.bwd_launches)
    made, (y, S, cd) = allocations(
        lambda: sc.ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=L))
    assert made == [((Bsz, T, H, P), f32), ((Bsz, nc, H, N, P), f32),
                    ((Bsz, T, H), f32)]
    dy, dS, dcd = torch.empty_like(y), \
        torch.empty_like(S) if with_dS else None, torch.empty_like(cd)
    made, grads = allocations(lambda: sc.ssd_chunk_bwd_cuda(
        x, dt, A, Bm, Cm, dy, dS, dcd, chunk=L))
    kbs = sc.bwd_s_splits(Bsz * nc, N, H, fa.SMS) if with_dS else 1
    ldc, groups = -(-L // 4) * 4, -(-H // sc.BWD_HEADS)
    want = [((Bsz, T, H, P), f32), ((Bsz, T, H), f32), ((Bsz, T, N), f32),
            ((Bsz, T, N), f32)]
    want += [((kbs, Bsz, T, N), f32)] * (kbs > 1)
    want += [((Bsz, nc, L, ldc), f32), ((Bsz, nc, groups, L, ldc), f32),
             ((Bsz, nc, H), f32), ((Bsz, T, H), f32)]
    assert made[:len(want)] == want
    assert [tuple(g.shape) for g in grads] == [
        tuple(x.shape), tuple(dt.shape), (H,), tuple(Bm.shape),
        tuple(Cm.shape)]
    assert (sc.launches, sc.bwd_launches) == before


def test_meta_route_reports_operations_and_cpu_still_refused():
    """The meta routes tell ``_build.meta_observers`` the bound's
    operations; a CPU or mixed call still raises as before."""
    seen = []
    _build.meta_observers.append(lambda *a: seen.append(a[:2]))
    try:
        q, k, v = _b9(1, 64, 64, 2, 1, 32, torch.bfloat16)
        fa.flash_attention_cuda(q, k, v, causal=False)
    finally:
        _build.meta_observers.pop()
    assert seen == [("flash_attention", 4.0 * 32 * 2 * 64 * 64)]
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(*cpu, causal=False)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(cpu[0], k, v, causal=False)


def test_autograd_functions_run_backward_on_meta():
    q, k, v = (t.requires_grad_(True)
               for t in _b9(1, 64, 64, 4, 2, 32, torch.bfloat16))
    out = ops.flash_attention(q, k, v, causal=True)
    gq, gk, gv = torch.autograd.grad(out.sum(), [q, k, v])
    assert (gq.shape, gk.shape, gv.shape) == (q.shape, k.shape, v.shape)
    x = torch.empty(1, 64, 4, 16, **META, requires_grad=True)
    dt = torch.empty(1, 64, 4, **META, requires_grad=True)
    A = torch.empty(4, **META, requires_grad=True)
    Bm = torch.empty(1, 64, 8, **META, requires_grad=True)
    y, S, _cd = ops.ssd_intra_chunk(x, dt, A, Bm, Bm, chunk=32)
    grads = torch.autograd.grad((y.sum() + S.sum()), [x, dt, A, Bm])
    assert [g.shape for g in grads] == [x.shape, dt.shape, A.shape,
                                        Bm.shape]


def test_visible_pairs_counts_causal_rows():
    for Tq, Tk in ((5, 5), (3, 7), (7, 3), (1, 1), (4, 0)):
        want = sum(max(0, min(Tk, i + Tk - Tq + 1)) for i in range(Tq))
        assert fa.visible_pairs(Tq, Tk, True) == want
    assert fa.visible_pairs(3, 7, False) == 21


def _attention_by_hand(B, Tq, Tk, H, hd, causal, backward):
    """Each (row, head, query i, key j) that i sees (end-aligned mask):
    forward s = q.k and o += p v, backward s, dp = do.v, dv += p do,
    dq += ds k and dk += ds q, each 2 hd."""
    total = 0
    for _b in range(B):
        for _h in range(H):
            for i in range(Tq):
                for j in range(Tk):
                    if causal and j > i + Tk - Tq:
                        continue
                    total += (5 if backward else 2) * 2 * hd
    return total


@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal", [
    (2, 5, 5, 4, 8, True),       # square prefill
    (1, 7, 3, 3, 16, True),      # Tq > Tk: the first rows see no key
    (2, 3, 7, 5, 4, True),       # a chunk after a cache, 5 heads
    (1, 1, 9, 5, 8, True),       # one decoded token, 5 heads
    (2, 3, 7, 6, 4, False)])
@pytest.mark.parametrize("backward", [False, True])
def test_attention_operations_equal_a_count_by_hand(B, Tq, Tk, H, hd,
                                                    causal, backward):
    """B9's operation count (its meta route's and the dry run's cost)
    against every visible pair counted one by one."""
    assert fa.operations(B, Tq, Tk, H, hd, causal, backward=backward) == \
        _attention_by_hand(B, Tq, Tk, H, hd, causal, backward)


def _ssd_by_hand(Bsz, T, H, Pd, N, L, backward):
    """Each chunk's pairs (j <= i) and positions: forward C_i.B_j once
    per (row, chunk) (2 N), y_i += w_ij x_j per head (2 Pd), and the
    chunk's state S += B_i x_i^T per head and position (2 N Pd);
    backward C_i.B_j, dC_i += g_ij B_j and dB_j += g_ij C_i once (6 N),
    G_ij = dy_i.x_j and dx_j += w_ij dy_i per head (4 Pd), u = B_i dS and
    dB_i's state term per head and position (4 N Pd)."""
    total = 0
    for _b in range(Bsz):
        for c in range(T // L):
            for i in range(L):
                for j in range(i + 1):
                    total += (6 if backward else 2) * N
                    for _h in range(H):
                        total += (4 if backward else 2) * Pd
                for _h in range(H):
                    total += (4 if backward else 2) * N * Pd
    return total


@pytest.mark.parametrize("Bsz,T,H,Pd,N,L", [
    (2, 12, 3, 4, 5, 4), (1, 8, 2, 3, 2, 8), (1, 6, 5, 2, 3, 1),
    (3, 10, 1, 8, 4, 5)])
@pytest.mark.parametrize("backward", [False, True])
def test_ssd_operations_equal_a_count_by_hand(Bsz, T, H, Pd, N, L,
                                              backward):
    """B10's and its backward's operation counts against every pair and
    position of every chunk counted one by one."""
    assert sc.operations(Bsz, T, H, Pd, N, L, backward=backward) == \
        _ssd_by_hand(Bsz, T, H, Pd, N, L, backward)


SMALL = {"n_layers": 2}


def test_accum_is_the_least_power_of_two_that_fits(monkeypatch):
    """The reference's search at a small budget: doubled from 1 while the
    footprint exceeds it and accum * 2 <= global_batch // dp."""
    cfg = dataclasses.replace(dryrun.get_config("mamba2_130m"), **SMALL)
    shape = dryrun.SHAPES["train_4k"]
    tmpl = t_mesh.make_production_mesh()
    arg = dryrun.argument_bytes(cfg, shape, tmpl)["total"]
    foot = {}
    for a in (1, 2, 4, 8, 16):
        mem = dryrun.memory_record(arg, dryrun.trace_cell(
            cfg, shape, tmpl, accum=a, cost=False))
        foot[a] = (mem["argument_bytes"] + mem["temp_bytes"]
                   + mem["output_bytes"] - mem["alias_bytes"])
    assert foot[1] > foot[2] > foot[4]
    for budget, want, fits in ((foot[1], 1, True), (foot[2], 2, True),
                               (foot[4], 4, True), (foot[16] - 1, 16, False)):
        monkeypatch.setattr(dryrun, "HBM_BUDGET", budget)
        got = dryrun.run_cell("mamba2_130m", "train_4k", verbose=False,
                              cost_variants=False, overrides=SMALL)
        assert (got["accum"], got["fits_hbm"]) == (want, fits), budget
        assert got["footprint_bytes"] == foot[want]
    # prefill and decode trace once, at accum 1
    monkeypatch.setattr(dryrun, "HBM_BUDGET", 1)
    got = dryrun.run_cell("mamba2_130m", "prefill_32k", verbose=False,
                          cost_variants=False, overrides=SMALL)
    assert (got["accum"], got["fits_hbm"]) == (1, False)


#: the keys of a record of the reference's ``run_cell``
#: (repro/launch/dryrun.py:221-301: ``result`` at :221-225, compile_s /
#: accum / memory / fits_hbm / footprint_bytes / cost_raw /
#: collectives_raw at :250-256, cost at :285-287, model_flops / tokens
#: at :298-299)
REF_KEYS = {"arch", "shape", "multi_pod", "mesh", "kind", "compile_s",
            "accum", "memory", "fits_hbm", "footprint_bytes", "cost_raw",
            "collectives_raw", "cost", "model_flops", "tokens"}


@pytest.mark.parametrize("cost", [True, False])
def test_record_keys_are_the_references(cost):
    got = dryrun.run_cell("mamba2_130m", "decode_32k", verbose=False,
                          cost_variants=cost, overrides=SMALL)
    # the reference's --no-cost drops only ``cost`` (its ``cost_raw`` comes
    # free with the compile, :254); the port counts both in the trace that
    # --no-cost skips, so both go
    want = REF_KEYS if cost else REF_KEYS - {"cost", "cost_raw"}
    assert set(got) == want | {"argument_bytes"}
    # _mem_dict's keys (:155-162), _cost_dict's (:149-152) and
    # collective_bytes' (:102-147), read off the reference's own code
    assert set(got["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert set(got["collectives_raw"]) == set(r_dryrun.collective_bytes(""))
    if cost:
        assert set(got["cost_raw"]) == {"flops", "bytes"}
        assert set(got["cost"]) == {"flops", "bytes", "collectives"}
        assert got["cost"]["collectives"] == got["collectives_raw"]
    mem = got["memory"]
    assert got["footprint_bytes"] == (mem["argument_bytes"]
                                      + mem["temp_bytes"]
                                      + mem["output_bytes"]
                                      - mem["alias_bytes"])


def test_prefill_flops_of_one_dense_layer_by_hand():
    """qwen3-14b's smoke config at one layer, prefill of 2 x 64 on one
    device: q / k / v / o projections, the swiglu MLP's three products,
    B9's 4 hd per visible (causal) pair and head, and the last position's
    logits."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_14b"), n_layers=1)
    B, T = 2, 64
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    one = t_mesh.Mesh(("data", "model"), (1, 1))
    got = dryrun.trace_cell(cfg, Shape("p", "prefill", T, B), one)
    rows = B * T
    want = (2 * rows * d * (H + 2 * KV) * hd        # q, k, v
            + 2 * rows * H * hd * d                 # o
            + 3 * 2 * rows * d * cfg.d_ff           # wi, wg, wo
            + 4 * hd * H * B * T * (T + 1) // 2     # B9
            + 2 * B * d * cfg.vocab_size)           # last logits
    assert got["flops"] == want
    assert got["kernels"] == {"flash_attention": (1, float(
        4 * hd * H * B * T * (T + 1) // 2))}


@pytest.mark.parametrize("arch", PORTED)
def test_one_device_mesh_traces_the_whole_batch(arch):
    """On one device the step takes the whole batch (no rank's shard, no
    ``StoredLeaf``), as phase 35 (d) traces phases 24, 32 and 34."""
    cfg = get_smoke_config(arch)
    one = t_mesh.Mesh(("data", "model"), (1, 1))
    mesh, comm = dryrun.rank_mesh(one)
    step, args = dryrun.step_and_args(cfg, Shape("t", "train", 32, 4), mesh,
                                      accum=2)
    assert comm is None and all(isinstance(v, torch.Tensor)
                                for v in args[-1].values())
    got = dryrun.trace_cell(cfg, Shape("t", "train", 32, 4), one, accum=2)
    assert got["peak"] > got["held"] > 0 and "comm" not in got


@pytest.mark.parametrize("arch", ["qwen3_14b", "mamba2_130m",
                                  "whisper_large_v3"])
def test_kept_shapes_change_nothing(arch):
    """A train step on rank 1 of a (data=2, model=2) mesh: the trace that
    makes repeated operations' outputs from their kept shapes gives the
    record of the one that runs every meta kernel."""
    cfg = dataclasses.replace(get_smoke_config(arch), fsdp=True)
    tmpl = t_mesh.Mesh(("data", "model"), (2, 2))
    got = []
    for cache in (True, False):
        mesh, comm = dryrun.rank_mesh(tmpl, 1)
        step, args = dryrun.step_and_args(
            cfg, Shape("t", "train", 32, 4), mesh, accum=2)
        rec = meta_trace.trace(step, args, cache=cache)
        rec.pop("seconds")
        got.append((rec, comm.counters(), comm.collective_bytes()))
    assert got[0] == got[1]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "whisper_large_v3",
                                  "qwen2_vl_72b"])
def test_kept_shapes_change_nothing_in_inference(arch, kind):
    """Prefill and decode steps on rank 1 of a (data=2, model=2) mesh,
    where operations whose schema declares no alias return a view of
    their argument (``_unsafe_view``): such a call is neither kept nor
    counted as moving bytes, so both traces give one record."""
    cfg = get_smoke_config(arch)
    tmpl = t_mesh.Mesh(("data", "model"), (2, 2))
    got = []
    for cache in (True, False):
        mesh, comm = dryrun.rank_mesh(tmpl, 1)
        step, args = dryrun.step_and_args(cfg, Shape("s", kind, 64, 4), mesh)
        rec = meta_trace.trace(step, args, cache=cache)
        rec.pop("seconds")
        got.append((rec, comm.counters()))
    assert got[0] == got[1]


def test_a_call_on_its_arguments_storage_is_a_view():
    """``_unsafe_view`` returns its argument's storage under a schema
    that declares none: no new storage, no bytes moved, nothing kept."""
    x = torch.empty(6, 4, **META)

    def step(x):
        y = x * 2                                      # 96 bytes
        return [torch.ops.aten._unsafe_view(y, (4, 6)) for _ in range(3)]

    for cache in (True, False):
        got = meta_trace.trace(step, (x,), cache=cache)
        assert got["peak"] == 96 + 96 and got["returned"] == 96
        assert got["bytes"] == 96 + 96


#: the five meshes of tests/test_torch_tp_plan.py
MESHES = {
    "production": t_mesh.make_production_mesh(),
    "production_pod": t_mesh.make_production_mesh(multi_pod=True),
    "data4": t_mesh.Mesh(("data", "model"), (4, 1)),
    "data2_model2": t_mesh.Mesh(("data", "model"), (2, 2)),
    "pod2_data2_model2": t_mesh.Mesh(("pod", "data", "model"), (2, 2, 2)),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_counting_comm_groups_on_the_plan_meshes(name):
    """Every rank's group along each set of axes holds the ranks that
    share its coordinates off them, in ascending order, and its index is
    its place there; ``leaf_plan`` (through ``steps.tp_plan``) on a
    rank's counting mesh is the plan of the mesh record, for every arch."""
    tmpl = MESHES[name]
    names, sizes = tmpl.axis_names, tmpl.axis_sizes
    plans = {arch: steps.tp_plan(dryrun.get_config(arch), tmpl)
             for arch in PORTED}
    probe = min(17, tmpl.size - 1)
    for rank in sorted({0, 1, probe, tmpl.size - 1}):
        mesh, comm = dryrun.rank_mesh(tmpl, rank)
        me = mesh.coords
        for bits in range(1, 1 << len(names)):
            axes = tuple(a for i, a in enumerate(names) if bits >> i & 1)
            grp, size, index = mesh.group(axes)
            members = [r for r in range(tmpl.size) if all(
                dataclasses.replace(mesh, comm=meta_trace.CountingComm(
                    r, tmpl.size)).coords[a] == me[a]
                for a in names if a not in axes)] if rank == probe else None
            assert size == t_mesh.axis_size(mesh, axes)
            if size == 1:
                assert grp is None and index == 0
                continue
            assert grp.size == size
            assert rank in grp.ranks and list(grp.ranks) == sorted(grp.ranks)
            assert grp.ranks.index(rank) == index
            if members is not None:
                assert list(grp.ranks) == members
        if sizes[-1] > 1:
            assert mesh.tp.index == me["model"] and mesh.tp.size == sizes[-1]
        assert mesh.dp.size == tmpl.size // sizes[-1]
        for arch, want in plans.items():
            assert steps.tp_plan(dryrun.get_config(arch), mesh) == want, \
                (arch, rank)


def test_counting_comm_counts_as_distributed_comm():
    """Results of ``DistributedComm``'s shapes, its counters, and the
    reference's wire bytes (all-gather result (g-1)/g, reduce-scatter
    result (g-1), all-reduce 2 result (g-1)/g, g the whole mesh where the
    group is None)."""
    comm = meta_trace.CountingComm(3, 8)
    g = comm.group([list(range(0, 8, 2)), list(range(1, 8, 2))])
    assert g.ranks == (1, 3, 5, 7)
    x = torch.empty(6, 5, dtype=torch.bfloat16, **META)      # 60 bytes
    y = torch.empty(8, 5, **META)                            # 160 bytes
    assert tuple(comm.all_gather_group(x, g, 4).shape) == (4, 6, 5)
    assert tuple(comm.reduce_scatter(y, g, 4).shape) == (2, 5)
    assert tuple(comm.all_reduce(x).shape) == (6, 5)
    assert comm.all_gather_group(x, None, 1).shape == (1, 6, 5)
    assert comm.calls == {"all_gather_group": 1, "reduce_scatter": 1,
                          "all_reduce": 1}
    assert comm.bytes == {"gathered": 3 * 60, "reduced": 160 + 60}
    assert comm.collective_bytes() == {
        "all-gather": 240 * 3 // 4, "reduce-scatter": 40 * 3,
        "all-reduce": 2 * 60 * 7 // 8, "all-to-all": 0,
        "collective-permute": 0, "count": 3, "wire_total": 180 + 120 + 105}
