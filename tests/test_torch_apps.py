"""The port's applications (n-body, PCIT) held against the JAX package's.

One JAX subprocess (8 fake CPU devices, as tests/test_engine_modes.py runs
the reference) writes every reference output of this module to an
``.npz``; the port runs in-process on the CPU, where the kernel paths
(``use_kernel`` / ``use_kernels``) take the plain versions.

  * n-body at P = 4, N = 32 in every mode: within 1e-4 of max |force| of
    the JAX engine and of the numpy oracle (tests/test_engine_modes.py);
  * PCIT at (P, N, G) = (5, 30, 18) and (8, 64, 24), batched / overlap /
    scan, with and without kernels: corr within rtol 1e-4 / atol 1e-5, and
    keep exactly equal to the JAX result and to ``pcit_reference``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.apps import nbody as r_nbody
from repro_torch.apps import nbody, pcit
from repro_torch.core.comm import SingleProcessComm

SRC = Path(__file__).resolve().parents[1] / "src"
NBODY_MODES = ("batched", "overlap", "scan", "auto")
PCIT_CASES = {"P5": (5, 30, 18, 4, 0.5), "P8": (8, 64, 24, 6, 0.4)}
MODES = ("batched", "overlap", "scan")


def bodies_np():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(size=(32, 3)),
                           rng.uniform(0.5, 2, (32, 1))], -1).astype(np.float32)


def expression_np(N, G, rank, noise):
    rng = np.random.default_rng(0)
    Z = rng.normal(size=(rank, G))
    return (rng.normal(size=(N, rank)) @ Z
            + noise * rng.normal(size=(N, G))).astype(np.float32)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.apps.nbody import distributed_forces
from repro.apps.pcit import run_quorum_pcit

def mesh(P):
    return jax.make_mesh((P,), ("q",), devices=jax.devices()[:P],
                         axis_types=(jax.sharding.AxisType.Auto,))

out = {}
bodies = np.load(sys.argv[2])
for mode in %(nbody_modes)r:
    out[f"nbody_{mode}"] = np.asarray(distributed_forces(
        jnp.asarray(bodies), mesh(4), mode=mode))
for name, P in %(pcit)r:
    X = np.load(sys.argv[2].replace("bodies", name))
    for mode in ("batched", "overlap", "scan"):
        corr, keep = run_quorum_pcit(X, mesh(P), mode=mode)
        out[f"{name}_{mode}_corr"], out[f"{name}_{mode}_keep"] = corr, keep
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ref")
    np.save(d / "bodies.npy", bodies_np())
    for name, (P, N, G, rank, noise) in PCIT_CASES.items():
        np.save(d / f"{name}.npy", expression_np(N, G, rank, noise))
    code = REFERENCE % {"nbody_modes": NBODY_MODES,
                        "pcit": [(n, c[0]) for n, c in PCIT_CASES.items()]}
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    r = subprocess.run([sys.executable, "-c", code, str(d / "apps.npz"),
                        str(d / "bodies.npy")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(d / "apps.npz"))


@pytest.fixture(scope="module")
def pcit_oracle():
    return {name: pcit.pcit_reference(expression_np(N, G, rank, noise))
            for name, (P, N, G, rank, noise) in PCIT_CASES.items()}


@pytest.mark.parametrize("mode,use_kernel", [(m, False) for m in NBODY_MODES]
                         + [("batched", True), ("auto", True)])
def test_nbody_matches_jax(reference, mode, use_kernel):
    b = bodies_np()
    got = nbody.distributed_forces(torch.as_tensor(b),
                                   SingleProcessComm(4, "cpu"), mode=mode,
                                   use_kernel=use_kernel).numpy()
    # the reference's fused Pallas kernel does not run on jax 0.9 (pl.load
    # was removed), so every port mode is held against the JAX engine's
    # plain path of the same mode (batched for the kernel path)
    want = reference[f"nbody_{mode}"]
    oracle = nbody.forces_reference(b)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 1e-4


def test_nbody_atom_strategy_and_guards():
    b = bodies_np()
    comm = SingleProcessComm(4, "cpu")
    got = nbody.distributed_forces(b, comm, strategy="atom").numpy()
    oracle = nbody.forces_reference(b)
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 1e-4
    for kwargs in [dict(mode="overlap", use_kernel=True),
                   dict(strategy="atom", use_kernel=True)]:
        with pytest.raises(ValueError, match="use_kernel"):
            nbody.distributed_forces(b, comm, **kwargs)
    with pytest.raises(ValueError, match="divisible"):
        nbody.distributed_forces(b[:30], comm)


def test_forces_fn_cached_per_comm():
    comm = SingleProcessComm(4, "cpu")
    assert nbody.forces_fn(comm) is nbody.forces_fn(comm)
    assert nbody.forces_fn(comm) is not nbody.forces_fn(
        SingleProcessComm(4, "cpu"))


def test_leapfrog_matches_jax():
    rng = np.random.default_rng(3)
    b = bodies_np()
    vel = rng.normal(size=(32, 3)).astype(np.float32)
    f = nbody.forces_reference(b).astype(np.float32)
    tb, tv = nbody.leapfrog_step(torch.as_tensor(b), torch.as_tensor(vel),
                                 1e-2, torch.as_tensor(f))
    rb, rv = r_nbody.leapfrog_step(jnp.asarray(b), jnp.asarray(vel), 1e-2,
                                   jnp.asarray(f))
    np.testing.assert_allclose(tb.numpy(), np.asarray(rb), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(PCIT_CASES))
def test_pcit_matches_jax(reference, pcit_oracle, case, mode, use_kernels):
    P, N, G, rank, noise = PCIT_CASES[case]
    X = expression_np(N, G, rank, noise)
    corr, keep = pcit.run_quorum_pcit(X, SingleProcessComm(P, "cpu"),
                                      use_kernels=use_kernels, mode=mode)
    assert corr.shape == (N, N) and keep.dtype == torch.bool
    np.testing.assert_allclose(corr.numpy(), reference[f"{case}_{mode}_corr"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(corr.numpy(), pcit.correlation_reference(X),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(keep.numpy(),
                                  reference[f"{case}_{mode}_keep"])
    np.testing.assert_array_equal(keep.numpy(), pcit_oracle[case])


def test_pcit_env_override_and_guards(monkeypatch):
    X = expression_np(30, 18, 4, 0.5)
    monkeypatch.setenv("REPRO_ALLPAIRS_MODE", "overlap")
    corr, keep = pcit.run_quorum_pcit(X, SingleProcessComm(5, "cpu"))
    np.testing.assert_allclose(corr.numpy(), pcit.correlation_reference(X),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        pcit.run_quorum_pcit(X[:29], SingleProcessComm(5, "cpu"))
    with pytest.raises(ValueError, match="unknown mode"):
        pcit.run_quorum_pcit(X, SingleProcessComm(5, "cpu"), mode="fast")


def test_standardize_matches_reference():
    from repro.apps import pcit as r_pcit
    X = expression_np(30, 18, 4, 0.5)
    np.testing.assert_array_equal(pcit.standardize(X), r_pcit.standardize(X))
