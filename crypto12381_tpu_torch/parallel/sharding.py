"""Sharded MSM, pairing products, batched pairings and PS verification
over a torch.distributed process group.

Counterpart of the JAX package's `parallel/sharding.py`, with the same
functions, patterns and divisibility rules:
  * sharded MSM: each rank runs the scan Pippenger on its point shard,
    the D partial points are all-gathered (D points of traffic) and
    combined by a log-tree of complete adds, the same on every rank;
  * sharded multi-pairing: a Miller product per rank, all_gather, the Fp12
    product in rank order, one final exponentiation;
  * sharded batched pairing: a pairing per row on each rank's shard, then
    an all_gather of the rows;
  * sharded PS verify: the whole verify on each rank's shard, the
    verdicts gathered.

The calling convention.  The JAX package has one controller: its caller
passes global arrays and sees a global result.  Here one process runs per
rank, and every rank passes the same full inputs, takes its rows
[rank n / D, (rank + 1) n / D), and returns the JAX function's whole
result.  Each function makes exactly ONE collective, an all_gather;
`COLLECTIVES` counts them, as `_build.LAUNCHES` counts kernel launches.

A mesh needs an initialized process group, with the backend of its
device: NCCL between CUDA cards, gloo on the CPU.  For example, on the
CPU with a file store in a temporary directory (no network):

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=D)
    mesh = default_mesh(device="cpu")

or under `torchrun --nproc-per-node D`, with init_process_group("nccl")
and default_mesh() on the card cuda:<LOCAL_RANK>.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..api import batch as BT
from ..curves import g1 as G1
from ..curves import weierstrass as W
from ..fields import tower as TW
from ..msm import pippenger as MSM
from ..pairing import pairing as PAIR

__all__ = ["COLLECTIVES", "Mesh", "default_mesh", "sharded_batched_pairing", "sharded_msm",
           "sharded_multi_pairing", "sharded_ps_verify"]

#: collectives made by the functions of this module
COLLECTIVES = 0


@dataclass(frozen=True)
class Mesh:
    """A process group of `size` ranks, this process's `rank` in it, and
    the device its shard runs on."""

    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device


def default_mesh(device=None) -> Mesh:
    """The mesh of the initialized default process group.  device: by
    default the card cuda:<local rank> (LOCAL_RANK as torchrun sets it,
    else the rank modulo the card count); device="cpu" runs the plain
    versions.  Raises without a process group (there is no silent world of
    one) and, by default, without a card."""
    if not dist.is_initialized():
        raise RuntimeError("default_mesh needs an initialized torch.distributed process group")
    group = dist.group.WORLD
    rank = dist.get_rank(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh runs on CUDA cards by default and none is present; "
                               "pass device='cpu' to run the plain versions")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = f"cuda:{local}"
    return Mesh(group, dist.get_world_size(group), rank, torch.device(device))


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(...) on every rank -> (D, ...) in rank order: one collective."""
    global COLLECTIVES
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    COLLECTIVES += 1
    return torch.stack(parts, 0)


def _shard(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor whose leading axis divides by D, on
    the mesh's device."""
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over {mesh.size} ranks")
    k = n // mesh.size
    return t[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)


def _tree_reduce_points(ops: W.FieldOps, stacked: torch.Tensor):
    """(D, 3, *elem) stacked points -> one point tuple by a log-tree of
    complete adds (the odd one out carried to the next level)."""
    while stacked.shape[0] > 1:
        half = stacked.shape[0] // 2
        s = W.stack_point(ops, W.add(ops, W.unstack_point(ops, stacked[:half]),
                                     W.unstack_point(ops, stacked[half:2 * half])))
        stacked = torch.cat([s, stacked[2 * half:]], 0)
    return W.unstack_point(ops, stacked[0])


def sharded_msm(mesh: Mesh, points, scalars_std, ops=None, c: int = 6, lanes: int = 256,
                gen_affine=None):
    """The MSM with the points and scalars sharded over the ranks.

    points: projective (X, Y, Z) of (n, *elem) tensors; scalars_std: (n, 18)
    standard-domain Fr limbs; n divides by D (and each shard pads to its
    lanes).  Returns the projective point tuple, the same on every rank."""
    ops = ops or G1.ops()
    gen_affine = gen_affine or MSM._gen_affine_g1(mesh.device)
    part = MSM.msm(tuple(_shard(mesh, c_) for c_ in points), _shard(mesh, scalars_std), ops,
                   c=c, lanes=lanes, gen_affine=gen_affine)
    return _tree_reduce_points(ops, _all_gather(mesh, W.stack_point(ops, part)))


def sharded_multi_pairing(mesh: Mesh, p_affs, q_affs):
    """prod_i e(P_i, Q_i) with the pairs sharded over the ranks.

    p_affs: (x, y) Fp tensors (n, 12); q_affs: (X, Y) Fp2 tensors
    (n, 2, 12); n divides by D.  Each rank's Miller product is gathered,
    multiplied in rank order, and one final exponentiation runs on the
    product.  Returns the GT value (2, 3, 2, 12), the same on every rank."""
    f = PAIR.multi_miller(tuple(_shard(mesh, t) for t in p_affs),
                          tuple(_shard(mesh, t) for t in q_affs))
    allf = _all_gather(mesh, f)
    acc = allf[0]
    for i in range(1, mesh.size):
        acc = TW.fp12_mul(acc, allf[i])
    return PAIR.final_exp(acc)


def sharded_batched_pairing(mesh: Mesh, p_affs, q_affs):
    """e(P_i, Q_i) row by row with the rows sharded over the ranks; n
    divides by D.  Returns all n GT values (n, 2, 3, 2, 12) on every
    rank."""
    f = PAIR.pairing_affine(tuple(_shard(mesh, t) for t in p_affs),
                            tuple(_shard(mesh, t) for t in q_affs))
    return _all_gather(mesh, f).flatten(0, 1)


def sharded_ps_verify(mesh: Mesh, s1, s2, g2e, X2e, Y2e, ms_std):
    """PS batch verification sharded over the ranks: each rank runs the
    whole verify on its shard (the GS G2 ladder for X2 Y2^m, the shared
    Miller loop of e(s1, X2 Y2^m) e(s2^-1, g2), one final exponentiation,
    the is_one check), and the verdicts are gathered.

    s1, s2: G1Vec of shape (B,); g2e, X2e, Y2e: host G2 elements; ms_std:
    (B, 18) Fr standard limbs.  B need not divide by D: the batch pads
    with identity signatures (whose slots verify True and are cut off).
    Returns a (B,) bool tensor on the mesh's device, the same on every
    rank."""
    B = ms_std.shape[0]
    pad = -B % mesh.size

    def rows(t, fill):
        return _shard(mesh, torch.cat([t, fill.to(t.device)], 0))

    ident = BT.G1Vec.identity((pad,), mesh.device).p
    s1p = tuple(rows(c, i) for c, i in zip(s1.p, ident))
    s2p = tuple(rows(c, i) for c, i in zip(s2.p, ident))
    ms = rows(ms_std, ms_std.new_zeros((pad, ms_std.shape[1])))
    nloc = ms.shape[0]
    X2, Y2, g2 = (BT.G2Vec.from_elements([e], mesh.device).broadcast_to((nloc,))
                  for e in (X2e, Y2e, g2e))
    t = X2 * (Y2 ** BT.ZpVec(ms))
    ok = BT.pair_prod((BT.G1Vec(s1p), t),
                      (BT.G1Vec(s2p).inverse(), g2)).is_one()
    return _all_gather(mesh, ok.to(torch.uint8)).flatten().bool()[:B]
