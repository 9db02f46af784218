"""The port's quorum and ring sequence-parallel attention
(``repro_torch/apps/attention.py``) held against the JAX package's.

One JAX subprocess (8 fake CPU devices, as tests/test_distributed.py runs
the reference) writes ``distributed_attention`` for both strategies at
P = 2, 5 and 8 to an ``.npz``; the port runs in-process on the CPU, where
each block pair is the plain flash block.  Inputs are made from a seed
with numpy: B = 2, H = 4, KV = 2, hd = 16, T = 64 (80 at P = 5, which
does not divide 64).  Bound: 1e-4 (tests/test_distributed.py's).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import attention as attn
from repro_torch.core.comm import SingleProcessComm
from repro_torch.core.scheduler import build_causal_schedule
from repro_torch.obs import trace as obs_trace

SRC = Path(__file__).resolve().parents[1] / "src"
B, H, KV, HD = 2, 4, 2, 16
PS = (2, 5, 8)
STRATEGIES = ("quorum", "ring")
TOL = 1e-4


def seq_len(P):
    return 64 if 64 % P == 0 else 80


def qkv_np(T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, HD)).astype(np.float32),
            rng.normal(size=(B, T, KV, HD)).astype(np.float32),
            rng.normal(size=(B, T, KV, HD)).astype(np.float32))


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.apps.attention import distributed_attention, reference_attention

out = {}
for P in %(ps)r:
    d = np.load(sys.argv[2] + f"/qkv{P}.npz")
    q, k, v = (jnp.asarray(d[n]) for n in ("q", "k", "v"))
    mesh = jax.make_mesh((P,), ("q",), devices=jax.devices()[:P],
                         axis_types=(jax.sharding.AxisType.Auto,))
    for strategy in %(strategies)r:
        out[f"{strategy}{P}"] = np.asarray(
            distributed_attention(q, k, v, mesh, strategy=strategy))
    out[f"reference{P}"] = np.asarray(reference_attention(q, k, v))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_attn")
    for P in PS:
        q, k, v = qkv_np(seq_len(P))
        np.savez(d / f"qkv{P}.npz", q=q, k=k, v=v)
    code = REFERENCE % {"ps": PS, "strategies": STRATEGIES}
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", code, str(d / "attn.npz"),
                        str(d)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(d / "attn.npz"))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_distributed_attention_matches_jax(reference, P, strategy):
    q, k, v = (torch.tensor(a) for a in qkv_np(seq_len(P)))
    comm = SingleProcessComm(P, "cpu")
    got = attn.distributed_attention(q, k, v, comm, strategy=strategy)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), reference[f"{strategy}{P}"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), reference[f"reference{P}"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), attn.reference_attention(q, k, v).numpy(), rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("P", PS)
def test_reference_attention_matches_jax(reference, P):
    q, k, v = (torch.tensor(a) for a in qkv_np(seq_len(P)))
    np.testing.assert_allclose(attn.reference_attention(q, k, v).numpy(),
                               reference[f"reference{P}"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_distributed_attention_bf16(strategy):
    """bf16 blocks (the models' dtype): each pair widens to float32, so
    the result equals the f32 attention of the same bf16 values up to the
    output's bf16 rounding (3e-2, the reference's bf16 kernel bound)."""
    q, k, v = (torch.tensor(a).bfloat16() for a in qkv_np(64, seed=3))
    got = attn.distributed_attention(q, k, v, SingleProcessComm(8, "cpu"),
                                     strategy=strategy)
    assert got.dtype == torch.bfloat16
    want = attn.reference_attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("P", PS)
def test_comm_bytes(P):
    """Quorum: k - 1 gather shifts of (q, k, v) and k - 1 scatter shifts of
    the (o, m, l) partials; ring: P - 1 shifts of (k, v)."""
    T = seq_len(P)
    q, k, v = (torch.tensor(a) for a in qkv_np(T))
    blk = T // P
    qkv_bytes = B * blk * (H + 2 * KV) * HD * 4
    part_bytes = B * blk * H * (HD + 2) * 4
    hops = sum(1 for a in build_causal_schedule(P).shifts if a % P)
    tr = obs_trace.configure(metrics_only=True)
    try:
        attn.distributed_attention(q, k, v, SingleProcessComm(P, "cpu"))
        assert tr.counter_total("comm.ppermute.gather_bytes") \
            == hops * qkv_bytes
        assert tr.counter_total("comm.ppermute.scatter_bytes") \
            == hops * part_bytes
        attn.distributed_attention(q, k, v, SingleProcessComm(P, "cpu"),
                                   strategy="ring")
        assert tr.counter_total("comm.ppermute.ring_hops") == P - 1
        assert tr.counter_total("comm.ppermute.ring_bytes") \
            == (P - 1) * B * blk * 2 * KV * HD * 4
    finally:
        obs_trace.reset()


def test_quorum_schedule_valid_slots():
    """At P = 8 (k = 4) 36 of the 64 (device, pair) slots are valid: the
    P (P + 1) / 2 causal block pairs, each computed once."""
    s = build_causal_schedule(8)
    assert s.k == 4 and s.n_pairs == 8
    assert int(s.valid.sum()) == 36
    assert set(s.valid.sum(1).tolist()) <= {4, 5}


def test_distributed_attention_refuses_bad_shapes():
    q = torch.zeros(1, 12, 4, 8)
    with pytest.raises(ValueError, match="divide"):
        attn.distributed_attention(q, q[:, :, :2], q[:, :, :2],
                                   SingleProcessComm(5, "cpu"))
    with pytest.raises(ValueError, match="strategy"):
        attn.distributed_attention(q, q[:, :, :2], q[:, :, :2],
                                   SingleProcessComm(4, "cpu"),
                                   strategy="flat")
