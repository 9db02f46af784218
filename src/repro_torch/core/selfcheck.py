"""Self-check of the port's quorum all-pairs engine.

Run as ``python -m repro_torch.core.selfcheck [P] [modes] [placement]
[--device cpu] [--dist gloo|nccl]`` (counterpart of
``repro/core/selfcheck.py``).  ``modes`` is a comma-separated subset of the
engine modes (default: all of batched, overlap, scan); ``placement`` is a
placement spec (a registered name, ``auto`` or ``plane``; unset defers to
``REPRO_PLACEMENT``).  It runs on the CUDA device unless ``--device cpu``
is given.  Without ``--dist`` the P devices share one process
(``SingleProcessComm``); with it, each of P processes started by torchrun
is one device (``DistributedComm`` over that backend), e.g.
``torchrun --standalone --nproc-per-node 8 -m repro_torch.core.selfcheck 8
--dist gloo --device cpu``.

Checks, for a toy n-body-style interaction: every engine mode under the
selected placement == allgather_allpairs == the numpy O(N^2) oracle, with
the reference's tolerances (rtol 2e-4, atol 2e-5).  Each process checks the
rows of the devices it holds.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .allpairs import (ENGINE_MODES, allgather_allpairs, pair_mask_table,
                       quorum_allpairs)
from .comm import (Comm, DistributedComm, SingleProcessComm, run_main, shard,
                   unshard)
from .placement import placement_from_env, resolve_placement


def pairwise_force(bi, bj):
    """Toy 1/r^2-ish interaction between blocks of 3D points [..., m, 3]
    and [..., n, 3]."""
    d = bi[..., :, None, :] - bj[..., None, :, :]        # [..., m, n, 3]
    r2 = torch.sum(d * d, dim=-1) + 1e-3
    f = d / (r2 ** 1.5)[..., None]
    return torch.sum(f, dim=-2), -torch.sum(f, dim=-3)


def oracle(x: np.ndarray) -> np.ndarray:
    """Numpy O(N^2) oracle for the toy interaction (i == j terms are 0)."""
    d = x[:, None, :] - x[None, :, :]
    r2 = (d * d).sum(-1) + 1e-3
    f = d / (r2 ** 1.5)[..., None]
    return f.sum(axis=1)


def main(nblocks: int = 8, modes: tuple[str, ...] = ENGINE_MODES,
         placement: str | None = None, device=None,
         comm: Comm | None = None) -> dict:
    """Run the engine self-check on ``comm`` (default: a
    ``SingleProcessComm`` of ``nblocks`` devices on ``device``); returns
    ``{"allgather": out, mode: out, ...}`` as numpy arrays of the rows of
    the devices this process holds ([N, 3] in one process; the tests hold
    them against the JAX package)."""
    Pn = int(nblocks)
    comm = SingleProcessComm(Pn, device) if comm is None else comm
    if comm.P != Pn:
        raise ValueError(f"the comm has P={comm.P} devices, not {Pn}")
    plc = (placement_from_env(Pn) if placement is None
           else resolve_placement(placement, Pn))
    sched = None if plc.full else plc.schedule()
    block = 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(Pn * block, 3)).astype(np.float32)
    xs = shard(x, comm)
    masks = None if sched is None else comm.local_rows(torch.as_tensor(
        pair_mask_table(sched))).to(comm.device)

    def run_quorum(mode):
        if plc.full:  # the engine routes to allgather; no mask applies
            out = quorum_allpairs(pairwise_force, xs, comm, mode=mode,
                                  placement=plc)
        else:
            out = quorum_allpairs(pairwise_force, xs, comm, schedule=sched,
                                  mask=masks, mode=mode, placement=plc)
        return unshard(out).cpu().numpy()

    want = oracle(x)[comm.local.start * block:comm.local.stop * block]
    got_a = unshard(allgather_allpairs(pairwise_force, xs, comm)).cpu().numpy()
    np.testing.assert_allclose(got_a, want, rtol=2e-4, atol=2e-5)
    outs = {"allgather": got_a}
    max_err = 0.0
    for mode in modes:
        got_q = run_quorum(mode)
        np.testing.assert_allclose(got_q, want, rtol=2e-4, atol=2e-5,
                                   err_msg=f"mode={mode} vs oracle")
        np.testing.assert_allclose(got_q, got_a, rtol=2e-4, atol=2e-5,
                                   err_msg=f"mode={mode} vs allgather")
        max_err = max(max_err, float(np.abs(got_q - want).max()))
        outs[mode] = got_q
    pairs = "P" if plc.full else str(sched.n_pairs)
    where = (f" rank={comm.rank} transport={comm.transport}"
             if isinstance(comm, DistributedComm) else "")
    print(f"selfcheck OK: P={Pn} placement={plc.describe()} "
          f"k={plc.replication} pairs/dev={pairs} "
          f"modes={','.join(modes)} device={comm.device}{where} "
          f"max|err|={max_err:.2e}")
    return outs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("P", nargs="?", type=int, default=8)
    ap.add_argument("modes", nargs="?", default=",".join(ENGINE_MODES))
    ap.add_argument("placement", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one process per device over torch.distributed "
                         "with this backend (start under torchrun)")
    args = ap.parse_args()
    run_main(main, args.P, tuple(args.modes.split(",")), args.placement,
             device=args.device, dist=args.dist)
