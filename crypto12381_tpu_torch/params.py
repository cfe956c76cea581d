"""BLS12-381 curve parameters and the port's Montgomery constants.

The curve constants are the standard, publicly specified BLS12-381 values
(IETF pairing-friendly-curves / RFC 9380), the same integers as the JAX
package's `crypto12381_tpu/params.py`.

Fp elements in this package are 12 little-endian 32-bit limbs in
Montgomery form with R = 2^384, and Fr elements in the kernels' arithmetic
are 8 limbs with R = 2^256 (see fields/fp.py).  The plain PyTorch versions
of the kernels work on 24 (Fp) or 16 (Fr) words of 16 bits with the same
R, so both give the same canonical limbs.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Curve constants
# ---------------------------------------------------------------------------

#: Base field prime p (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

#: Group order r (255 bits) = size of G1/G2/GT.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

#: BLS parameter x is negative: x = -X_ABS.  |x| has Hamming weight 6.
X_ABS = 0xD201000000010000
X_SIGN = -1

#: Effective G1 cofactor for clearing: 1 + |x| (the reference's CURVE_Cof).
H_EFF_G1 = X_ABS + 1

#: E/Fp: y^2 = x^3 + 4;  E'/Fp2: y^2 = x^3 + 4(1+i) (M-type sextic twist).
B_G1 = 4
B_G2 = (4, 4)  # 4*(1+i) as (real, imag)

G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator, coordinates in Fp2 = Fp[i] as (real, imag)
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

MODBYTES = 48          # one Fp element, big-endian
GT_BYTES = 576         # 12 Fp coefficients

#: xi = 1 + i: Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v).
XI = (1, 1)

#: Hash to G1: the simplified SWU map with Z = 11 onto the 11-isogenous
#: curve y^2 = x^3 + A'x + B' (RFC 9380 section 8.8.1), then the isogeny
#: (its coefficient table is iso11_data.py) and cofactor clearing.
SSWU_Z = 11
ISO11_A = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
ISO11_B = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0

# ---------------------------------------------------------------------------
# Montgomery constants for 32-bit limbs, R = 2^384
# ---------------------------------------------------------------------------

LIMBS = 12
LIMB_BITS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMBS * LIMB_BITS            # 384
MONT_R = 1 << R_BITS

#: p's limbs, little-endian.
P_LIMBS = [(P >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)]
#: n0' = -p^-1 mod 2^32 (CIOS word constant).
N0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
#: R mod p (Montgomery one) and R^2 mod p (to-Montgomery factor).
R_MOD = MONT_R % P
R2_MOD = (MONT_R * MONT_R) % P
#: R^-1 mod p (from-Montgomery factor on the host).
R_INV = pow(MONT_R, -1, P)

# The same R seen as 24 words of 16 bits (the plain versions' layout).
WORDS16 = 24
P_WORDS16 = [(P >> (16 * i)) & 0xFFFF for i in range(WORDS16)]
N0_16 = (-pow(P, -1, 1 << 16)) % (1 << 16)

assert 4 * P < MONT_R, "sums of two canonical values must fit 12 limbs"

# ---------------------------------------------------------------------------
# Montgomery constants of the scalar field Fr, R = 2^256
# ---------------------------------------------------------------------------

FR_LIMBS32 = 8
FR_R_BITS = FR_LIMBS32 * LIMB_BITS    # 256
FR_MONT_R = 1 << FR_R_BITS

#: r's limbs, little-endian.
FR_P_LIMBS = [(R >> (LIMB_BITS * i)) & LIMB_MASK for i in range(FR_LIMBS32)]
#: n0' = -r^-1 mod 2^32 (r = 1 mod 2^32, so it is 2^32 - 1).
FR_N0 = (-pow(R, -1, 1 << 32)) % (1 << 32)
FR_R_MOD = FR_MONT_R % R
FR_R2_MOD = (FR_MONT_R * FR_MONT_R) % R
FR_R_INV = pow(FR_MONT_R, -1, R)

FR_WORDS16 = 16
FR_P_WORDS16 = [(R >> (16 * i)) & 0xFFFF for i in range(FR_WORDS16)]
FR_N0_16 = (-pow(R, -1, 1 << 16)) % (1 << 16)

# Fp's operands may be raw sums below 2p because 4p < 2^384.  Fr has no
# such room: 4r > 2^256, and for a, b < 2r the reduced product can reach
# about 2.8r, past one conditional subtraction.  For a, b < r it stays
# below (r^2 + 2^256 r) / 2^256 < 2r, which needs only r < 2^256; the Fr
# product takes canonical operands only, and 2r < R keeps the CIOS top
# word 0.
assert 2 * R < FR_MONT_R, "the Fr product's result below 2r must fit 8 limbs"
