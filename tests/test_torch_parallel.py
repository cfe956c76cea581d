"""The port's sharding (parallel/sharding.py) on gloo worlds of 2 and 3
ranks on the CPU, against the port's unsharded calls and the JAX
package.

Each world runs in its own processes, one per rank (the rank code is this
file's `__main__`), joined by a file store in the test's temporary
directory, each under a timeout.  Every rank passes the same full inputs
and must return the whole result:
  * `sharded_msm` at n = 48, c = 8, lanes = 2: equal to the port's
    `msm_g1` and to the JAX `sharded_msm` on its 8-device CPU mesh (the
    shapes divide: 6 points a device), as canonical affine integers, and
    to the host oracle;
  * `sharded_multi_pairing` and `sharded_batched_pairing` over 6 pairs:
    equal to the port's `multi_pairing` and `pairing_affine` on the CPU,
    and, GT value by GT value and byte for byte, to the JAX package's
    pyref pairing (the oracle tests/test_parallel.py holds the JAX sharded
    pairings against; the JAX pairing graphs take minutes each to compile
    on the CPU, past this file's budget);
  * `ps.verify_batch(..., mesh=...)` at B = 10 (even over 2 ranks, uneven
    over 3: padded with identity signatures), with one tampered message:
    the port's unsharded verdicts and the JAX package's host `ps.verify`
    on every row;
  * one collective per call, whatever n is (sharded_msm at two sizes, as
    tests/test_parallel.py checks it).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
MSM_N, MSM_C, MSM_LANES = 48, 8, 2
PAIRS = 6
PS_SEED = "sharded-ps"
PS_B = 10
TAMPERED = 4

#: The JAX sharded_msm on the 8-device CPU mesh, in a child process.
JAX_SHARDED_MSM = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.parallel import sharding as SH
d = np.load(sys.argv[1])
p = tuple(jnp.asarray(d[k]) for k in ("X", "Y", "Z"))
mesh = SH.default_mesh()
assert mesh.devices.size == 8
out = SH.sharded_msm(mesh, p, jnp.asarray(d["s"]), c={MSM_C}, lanes={MSM_LANES})
np.save(sys.argv[2], np.stack([np.asarray(c) for c in out], 0))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in the test process while its ranks and JAX child
    run beside it (the plain versions run many small ops)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    """The points, scalars and pairs of every world (numpy, from a seed),
    and PS keys, messages (one tampered) and signatures from the port's
    host signer."""
    from crypto12381_tpu_torch.api.sets import create_random_engine
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R
    from crypto12381_tpu_torch.schemes import ps

    rng = np.random.default_rng(77)

    def ints(n):
        return [int.from_bytes(rng.bytes(48), "big") % (R - 1) + 1 for _ in range(n)]

    pts = [C.g1_mul(C.G1_GEN, k) for k in ints(MSM_N)]
    sc = ints(MSM_N)
    sc[5] = 0
    g1 = [C.g1_mul(C.G1_GEN, k) for k in ints(PAIRS)]
    g2 = [C.g2_mul(C.G2_GEN, k) for k in ints(PAIRS)]
    r = create_random_engine(PS_SEED)
    keys = ps.key_gen(r)
    msgs = [bytes([i + 1]) * 19 for i in range(PS_B)]
    sigs = [ps.sign(keys.sk, m, r) for m in msgs]
    msgs[TAMPERED] = b"tampered"
    return dict(pts=pts, sc=sc, g1=g1, g2=g2, pk=keys.pk, msgs=msgs, sigs=sigs)


def _tensors(d):
    """The inputs as the port's CPU tensors."""
    import torch

    from crypto12381_tpu_torch.api import batch as BT
    from crypto12381_tpu_torch.fields import fp as FP

    P = tuple(FP.from_int([[x, y, 1] for x, y in d["pts"]]).unbind(-2))
    s = torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in d["sc"]],
                     dtype=torch.int32)
    p_aff = BT.G1Vec.from_affine(d["g1"], device="cpu").p[:2]
    q_aff = BT.G2Vec.from_affine(d["g2"], device="cpu").p[:2]
    return P, s, p_aff, q_aff


def _rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank: every sharded function on the whole inputs; its results
    and collective counts to `out`."""
    import torch
    import torch.distributed as dist

    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.parallel import sharding as SH
    from crypto12381_tpu_torch.schemes import ps

    torch.set_num_threads(1)                   # one core per rank
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = SH.default_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank)
        d = _inputs()
        P, s, p_aff, q_aff = _tensors(d)
        res, colls = {}, []

        def counted(fn, *a, **kw):
            before = SH.COLLECTIVES
            r = fn(*a, **kw)
            colls.append(SH.COLLECTIVES - before)
            return r

        res["msm"] = torch.stack(counted(SH.sharded_msm, mesh, P, s, c=MSM_C, lanes=MSM_LANES))
        for n in (world * 4, world * 16):     # the count does not grow with n
            gen = G1.generator((n,), "cpu")
            counted(SH.sharded_msm, mesh, gen, torch.ones((n, 18), dtype=torch.int32), c=4,
                    lanes=2)
        res["multi"] = counted(SH.sharded_multi_pairing, mesh, p_aff, q_aff)
        res["batched"] = counted(SH.sharded_batched_pairing, mesh, p_aff, q_aff)
        res["ps"] = torch.from_numpy(counted(ps.verify_batch, d["pk"], d["msgs"], d["sigs"],
                                             mesh=mesh))
        res["collectives"] = torch.tensor(colls)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _pyref_gt(g1, g2):
    """The JAX package's pyref pairings of the pairs, canonical host Fp12."""
    from crypto12381_tpu.pyref import field as FJ
    from crypto12381_tpu.pyref import pairing as PJ

    return [FJ._fp12_canon(PJ.pairing(p, q)) for p, q in zip(g1, g2)]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_calls_match_unsharded_and_jax(world, tmp_path):
    import torch

    import crypto12381_tpu.schemes.ps as PSJ
    from crypto12381_tpu.pyref import field as FJ
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import pippenger as MSM
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    from crypto12381_tpu_torch.schemes import ps

    d = _inputs()
    P, s, p_aff, q_aff = _tensors(d)
    np.savez(tmp_path / "msm.npz", s=s.numpy(), **dict(zip("XYZ", convert.to_jax_point(P))))
    cmds = [[__file__, str(r), str(world), str(tmp_path / "store"), str(tmp_path / f"rank{r}.pt")]
            for r in range(world)]
    cmds.append(["-c", JAX_SHARDED_MSM, str(tmp_path / "msm.npz"), str(tmp_path / "jax_msm.npy")])
    logs = [tmp_path / f"child{i}.log" for i in range(len(cmds))]
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=ROOT, stdout=subprocess.DEVNULL,
                              stderr=log.open("w")) for cmd, log in zip(cmds, logs)]
    try:
        # the unsharded calls and the oracles while the ranks run
        msm = MSM.msm_g1(P, s, c=MSM_C, lanes=MSM_LANES)
        multi = PAIR.multi_pairing(p_aff, q_aff)
        batched = PAIR.pairing_affine(p_aff, q_aff)
        plain_ps = ps.verify_batch(d["pk"], d["msgs"], d["sigs"], device="cpu")
        jax_ps = [PSJ.verify(d["pk"], m, sg) for m, sg in zip(d["msgs"], d["sigs"])]
        gts = _pyref_gt(d["g1"], d["g2"])
        for p in procs:
            p.wait(timeout=1500)
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [log.read_text()[-2000:] for log in logs]

    expect_pt = C.g1_msm(d["pts"], d["sc"])
    jax_msm = G1.to_affine_ints(convert.from_jax_point(np.load(tmp_path / "jax_msm.npy")))
    assert G1.to_affine_ints(msm) == jax_msm == expect_pt
    prod = gts[0]
    for g in gts[1:]:
        prod = FJ._fp12_canon(FJ.fp12_mul(prod, g))
    assert TW.fp12_to_host(multi) == prod and TW.fp12_to_host(batched) == gts
    assert jax_ps == [i != TAMPERED for i in range(PS_B)]
    for r in range(world):
        res = torch.load(tmp_path / f"rank{r}.pt")
        assert G1.to_affine_ints(tuple(res["msm"].unbind(0))) == expect_pt, r
        assert torch.equal(res["multi"], multi) and torch.equal(res["batched"], batched), r
        assert codec.gt_serialize(TW.fp12_to_host(res["multi"])) == codec.gt_serialize(prod)
        assert [codec.gt_serialize(g) for g in TW.fp12_to_host(res["batched"])] == \
            [codec.gt_serialize(g) for g in gts]
        assert res["ps"].tolist() == plain_ps.tolist() == jax_ps, r
        # one all_gather per call: msm, msm at two more sizes, the two
        # pairings, the verify
        assert res["collectives"].tolist() == [1] * 6, r


def test_default_mesh_needs_a_process_group():
    from crypto12381_tpu_torch.parallel import sharding as SH

    with pytest.raises(RuntimeError, match="process group"):
        SH.default_mesh(device="cpu")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
