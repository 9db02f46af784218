"""Direct-interaction n-body forces on the port's quorum engine — the
paper's motivating algorithm family (atom decomposition vs quorums, paper
section 1.2); counterpart of ``repro/apps/nbody.py``.

The ``quorum`` strategy runs the engine (k*N/P bodies resident per
device); ``atom`` is the all-gather baseline (N bodies per device).
``use_kernel=True`` routes the batched step through the fused B1 kernel
(``kernels/pairwise_batch.py``).  Under either comm backend the entry
points return the forces on the bodies of the devices this process holds
([N, 3] in one process, [N/P, 3] a rank under ``DistributedComm``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.allpairs import (allgather_allpairs, pair_mask_table,
                             quorum_allpairs)
from ..core.comm import Comm
from ..core.scheduler import build_schedule
from ..kernels import ref as kref

SOFTENING = 1e-2


def pair_forces(bi: torch.Tensor, bj: torch.Tensor):
    """Gravity between body blocks [..., m, 4] (x, y, z, mass): (force on
    bi [..., m, 3], force on bj [..., n, 3]), each pair formed once."""
    return kref.nbody_pair(bi, bj, SOFTENING)


def forces_reference(bodies: np.ndarray) -> np.ndarray:
    """Numpy O(N^2) force oracle."""
    p, m = bodies[:, :3], bodies[:, 3]
    d = p[None, :, :] - p[:, None, :]
    r2 = (d * d).sum(-1) + SOFTENING
    w = (m[:, None] * m[None, :]) / (np.sqrt(r2) * r2)
    return (w[..., None] * d).sum(axis=1)


@functools.lru_cache(maxsize=64)
def forces_fn(comm: Comm, strategy: str = "quorum",
              mode: str = "auto", use_kernel: bool = False):
    """The distributed-forces callable ``f(bodies [N, 4]) -> forces`` on
    this process's bodies (``[N * len(comm.local) / P, 3]``) for
    ``comm``'s P devices, cached per (comm, strategy, mode, use_kernel) so
    simulation steps reuse one schedule and mask table."""
    P = comm.P
    if strategy == "quorum":
        sched = build_schedule(P)
        masks = comm.local_rows(torch.as_tensor(
            pair_mask_table(sched))).to(comm.device)
        batch_fn = None
        if use_kernel:
            if mode not in ("batched", "auto"):
                raise ValueError(
                    f"use_kernel needs the batched mode (got mode={mode!r}); "
                    "the fused kernel only replaces the batched inner step")
            from ..kernels import ops as kops
            batch_fn = functools.partial(kops.pairwise_batch_forces,
                                         softening=SOFTENING)

        def run(bodies):
            xb = _blocks(bodies, comm)
            out = quorum_allpairs(pair_forces, xb, comm, schedule=sched,
                                  mask=masks, mode=mode, batch_fn=batch_fn)
            return out.reshape(-1, 3)
        return run
    if strategy == "atom":
        if use_kernel:
            raise ValueError("use_kernel applies only to strategy='quorum'")

        def run(bodies):
            xb = _blocks(bodies, comm)
            return allgather_allpairs(pair_forces, xb, comm).reshape(-1, 3)
        return run
    raise ValueError(f"unknown strategy {strategy!r}")


def _blocks(bodies, comm: Comm) -> torch.Tensor:
    """[N, 4] bodies -> this process's [len(local), N // P, 4] blocks on
    its device; the rows are taken where the bodies lie (on the host, for
    host bodies) before the move, so a rank's device holds N/P bodies."""
    bodies = torch.as_tensor(bodies)
    if bodies.dim() != 2 or bodies.shape[1] != 4 or bodies.shape[0] % comm.P:
        raise ValueError(f"bodies must be [N, 4] with N divisible by "
                         f"P={comm.P}, got {tuple(bodies.shape)}")
    return comm.local_rows(bodies.reshape(comm.P, -1, 4)).to(comm.device)


def distributed_forces(bodies, comm: Comm, *,
                       strategy: str = "quorum", mode: str = "auto",
                       use_kernel: bool = False) -> torch.Tensor:
    """bodies: [N, 4] (x, y, z, mass), device i holding rows
    ``i*N/P : (i+1)*N/P``.  Returns the forces on the rows of the devices
    this process holds, on ``comm.device``: [N, 3] under
    ``SingleProcessComm``, rows ``r*N/P : (r+1)*N/P`` ([N/P, 3]) on rank r
    under ``DistributedComm``.

    ``mode`` selects the engine mode (batched / overlap / scan / auto);
    ``use_kernel`` routes the batched mode through the fused B1 kernel.
    """
    return forces_fn(comm, strategy, mode, use_kernel)(bodies)


def leapfrog_step(bodies: torch.Tensor, vel: torch.Tensor, dt: float,
                  forces: torch.Tensor):
    """Symplectic integrator step: returns (bodies, vel) advanced by dt."""
    m = bodies[:, 3:4]
    vel = vel + dt * forces / m
    pos = bodies[:, :3] + dt * vel
    return torch.cat([pos, bodies[:, 3:4]], dim=-1), vel
