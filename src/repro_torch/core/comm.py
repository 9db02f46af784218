"""The comm layer: a single-process stand-in for the reference's mesh.

The JAX package runs the P devices of a quorum axis as ``jax.shard_map``
over a mesh and moves blocks with ``lax.ppermute`` / ``lax.all_gather``
(``lax.axis_index`` names the device).  The port's first backend keeps all
P devices in one process on one torch device: every per-device tensor
carries a leading ``[P, ...]`` axis, and each collective is an index
permutation of that axis.  It runs the same way on the CPU and on one GPU.

:class:`SingleProcessComm` takes the place of the reference's ``mesh``
argument; :func:`shard` / :func:`unshard` move ``[N, ...]`` data in and out
of the ``[P, block, ...]`` layout, and :func:`schedule_from_numpy` carries a
schedule across from the reference so tests feed both packages the same
inputs.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .scheduler import PairSchedule

__all__ = [
    "resolve_device",
    "SingleProcessComm",
    "tree_map",
    "shard",
    "unshard",
    "pad_blocks",
    "schedule_from_numpy",
]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``None`` means the CUDA
    device, and asking for CUDA where there is none raises (the port never
    drops to the CPU unless the caller asks for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Map ``fn`` over the tensor leaves of a tuple / list / dict payload,
    named tuples included (the pytrees the reference's gather and scatter
    move)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        leaves = [tree_map(fn, *ls) for ls in zip(tree, *rest)]
        if hasattr(tree, "_fields"):          # a NamedTuple
            return type(tree)(*leaves)
        return type(tree)(leaves)
    return fn(tree, *rest)


class SingleProcessComm:
    """P simulated devices on one torch device (ROADMAP A.2, first backend).

    Per-device tensors are stacked on a leading ``[P, ...]`` axis.
    """

    def __init__(self, P: int, device=None):
        if int(P) < 1:
            raise ValueError(f"P must be >= 1, got {P}")
        self.P = int(P)
        self.device = resolve_device(device)

    def axis_index(self) -> torch.Tensor:
        """``lax.axis_index``: device i's own index, as a [P] tensor."""
        return torch.arange(self.P, device=self.device)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """The cyclic shift of ``core/sweep.py:_shift_perm``: device i
        receives device ``(i + shift) % P``'s tensor."""
        s = int(shift) % self.P
        if s == 0:
            return x
        return torch.roll(x, -s, dims=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather``: every device sees the whole ``[P, ...]``
        stack, so the result is ``[P (device), P (block), ...]`` (a
        broadcast view: one copy of the data stands for all P)."""
        return x.unsqueeze(0).expand(self.P, *x.shape)

    def __repr__(self) -> str:
        return f"SingleProcessComm(P={self.P}, device={self.device})"


def shard(x_np, comm: SingleProcessComm, dtype=None) -> torch.Tensor:
    """``[N, ...]`` array -> ``[P, N // P, ...]`` tensor on the comm's
    device: device i holds rows ``i*block : (i+1)*block``."""
    t = torch.as_tensor(np.asarray(x_np))
    if t.shape[0] % comm.P:
        raise ValueError(f"N={t.shape[0]} does not divide by P={comm.P}")
    t = t.to(device=comm.device, dtype=dtype)
    return t.reshape(comm.P, t.shape[0] // comm.P, *t.shape[1:])


def unshard(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shard`: ``[P, block, ...]`` -> ``[N, ...]``."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def pad_blocks(corpus, P: int, device) -> torch.Tensor:
    """The [N, d] corpus (numpy or tensor) zero-padded to P blocks of
    ceil(N / P) rows on ``device``: [P, block, d] float32."""
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    N, d = corpus.shape
    block = -(-N // P)
    x = torch.zeros(P * block, d, dtype=torch.float32, device=device)
    x[:N] = corpus.to(device)
    return x.reshape(P, block, d)


def schedule_from_numpy(P, A, shifts, pair_slots, pair_diff) -> PairSchedule:
    """The port's :class:`PairSchedule` from the numpy fields of another
    one (duck-typed: e.g. a reference ``repro.core.scheduler.PairSchedule``,
    without importing it)."""
    return PairSchedule(
        P=int(P),
        A=tuple(int(a) for a in A),
        shifts=np.asarray(shifts, dtype=np.int32),
        pair_slots=np.asarray(pair_slots, dtype=np.int32).reshape(-1, 2),
        pair_diff=np.asarray(pair_diff, dtype=np.int32),
    )
