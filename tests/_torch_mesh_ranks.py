"""Helpers shared by the tests that run the port's steps on a mesh of gloo
ranks beside the reference's sharded program in JAX subprocesses
(``tests/test_torch_distributed_train.py``,
``tests/test_torch_distributed_decode.py``): flat dicts of arrays for the
``.npz`` files they exchange, the spawns of the ranks and the dealing of
cells among the JAX subprocesses."""

import time

import numpy as np
import pytest
import torch.multiprocessing as mp

from repro_torch.models.common import tree_leaves


def flat(tree, prefix=""):
    """``{prefix + "a/b/c": array}`` of a nested dict's leaves."""
    return {prefix + "/".join(p): np.asarray(v) for p, v in tree_leaves(tree)}


def unflat(d, prefix):
    """The nested dict of the entries of ``d`` under ``prefix``."""
    out = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def join(ctxs, seconds):
    """Wait for every spawn; ranks still running after ``seconds`` are
    killed and fail the test."""
    deadline = time.monotonic() + seconds
    pending = list(ctxs)
    while pending:
        pending = [c for c in pending if not c.join(timeout=0.2)]
        if pending and time.monotonic() > deadline:
            for c in pending:
                for p in c.processes:
                    p.kill()
            pytest.fail(f"ranks still running after {seconds} s")


def spawn(fn, nprocs, args):
    """``nprocs`` ranks of ``fn(rank, *args)``, not joined."""
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def deal(cells, n, weight):
    """``cells`` in ``n`` parts of about equal weight (``weight`` of a
    cell's arch, 1 where not listed; the heaviest first, each to the
    lightest part so far)."""
    parts, load = [[] for _ in range(n)], [0] * n
    for c in sorted(cells, key=lambda c: -weight.get(c[0], 1)):
        i = load.index(min(load))
        parts[i].append(c)
        load[i] += weight.get(c[0], 1)
    return parts
