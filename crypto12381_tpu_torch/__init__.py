"""crypto12381_tpu_torch: the BLS12-381 pairing framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `crypto12381_tpu` that imports nothing from it.
Operations run where their tensors are: a CUDA tensor launches the CUDA
kernel, a CPU tensor runs the kernel's plain PyTorch version.

    from crypto12381_tpu_torch import G1Vec, ZpVec, pair_batch
    gt = pair_batch(g1_points, g2_points)            # on the CUDA card
    gt = pair_batch(g1_points, g2_points, device="cpu")
    pts = G1Vec.generator((n,)) ** ZpVec.from_ints(scalars)   # GLV ladder
    acc = pts.msm(ZpVec.from_ints(more_scalars))              # Pippenger (rounds from 2^17)
    q = G2Vec.generator((n,)) ** ZpVec.from_ints(scalars)    # GS ladder on G2
    gt = pair_vec(pts, q) ** ZpVec.from_ints(scalars)         # GT power
    one = pair_prod((pts, q), (pts.inverse(), q)).is_one()    # shared Miller loop

    from crypto12381_tpu_torch.api.sets import create_random_engine
    rng = create_random_engine("seed")                        # MIRACL's CSPRNG
    keys = key_gen(rng)                                       # PS, on the host
    sigs = sign_batch(keys.sk, messages, rng)                 # one GLV call
    ok = verify_batch(keys.pk, messages, sigs)                # (B,) bool

    pp = bbs.setup(16, rng); keys = bbs.key_gen(pp, rng)      # BBS (bbs_plus alike)
    sigs = bbs.sign_batch(pp, keys.sk, blocks, rng)           # blocks: encode_message
    ok = bbs.verify_batch(pp, keys.pk, blocks, sigs)          # (B,) bool
    shares = sss.share_batch(t, n, secret, rng)               # Shamir: one Horner ladder
    secret = sss.reconstruct_batch(indexes, shares[:t])

    keys = bbs04.key_gen(16, rng)                             # BBS04 group signatures
    ok = bbs04.verify_batch(keys.gpk, messages, sigs)         # device Fiat-Shamir (SHA3)
    ok = ac_bbs.verify_batch(m, attr, I, presentations, pk)   # ac_rbbs, ac_rps alike
    ok = ps.verify_n_batch(keys_n, messages, sigs)            # multi-message PS
    gt = pair(g1_element, g2_element)                         # the host pairing (lazy)

    press = mhac_bbs.cred_pres_batch(pp, creds, groups, types, Prv, attrs, shares, rng)
    ok = mhac_bbs.verify_pres_batch(pp, pk, ptype, Prv, attrs, press)   # MHAC-BBS
    pts = hash_to_g1(digests)                                 # SSWU hash to G1, (B, 64) uint8

    x, y = select_in(Zp ** 2, create_random_engine("seed"))   # the paper notation
    from crypto12381_tpu_torch.msm.sorted import msm_g1_sorted_staged   # batched-affine MSM
    acc = msm_g1_sorted_staged(pts.p, ZpVec.from_ints(more_scalars).std)

    mesh = sharding.default_mesh()                            # parallel/, after init_process_group
    ok = verify_batch(keys.pk, messages, sigs, mesh=mesh)     # each rank verifies its shard
"""

from ._build import LAUNCH_EXPONENTS, LAUNCH_ROWS, LAUNCH_STACKS, LAUNCHES, reset_launches
from .api.batch import (G1Vec, G2Vec, GTVec, ZpVec, hash_to_g1, pair_prod, pair_prod_fixed,
                        pair_vec)
from .api.elements import (G1Element, G1Pow, G2Element, GTElement, GTPair, ZpNumber, inverse,
                           pair)
from .api.sets import (G1, G2, GT, Zp, create_random_engine, encode_to, hash_, make_Zp, parse,
                       polynomial, product_, select_in, serialize, sum_)
from .msm.pippenger import msm_g1
from .pairing.pairing import pair_batch, pairing_affine
from .schemes import ac_bbs, ac_rbbs, ac_rps, bbs, bbs04, bbs_plus, mhac_bbs, ps, sss
from .schemes.ps import key_gen, randomnize, sign_batch, verify_batch

__all__ = [
    # the paper notation, as the JAX package exports it
    "G1", "G2", "GT", "Zp",
    "G1Element", "G1Pow", "G2Element", "GTElement", "GTPair", "ZpNumber",
    "create_random_engine", "encode_to", "hash_", "inverse", "make_Zp",
    "pair", "parse", "polynomial", "product_", "select_in", "serialize",
    "sum_",
    # the batched vectors, paths, schemes and launch counts
    "LAUNCHES", "LAUNCH_EXPONENTS", "LAUNCH_ROWS", "LAUNCH_STACKS", "G1Vec", "G2Vec", "GTVec",
    "ZpVec", "ac_bbs", "ac_rbbs", "ac_rps", "bbs", "bbs04", "bbs_plus", "hash_to_g1", "key_gen",
    "mhac_bbs", "msm_g1", "pair_batch", "pair_prod", "pair_prod_fixed", "pair_vec",
    "pairing_affine", "ps", "randomnize", "reset_launches", "sign_batch", "sss",
    "verify_batch",
]

__version__ = "0.1.0"
