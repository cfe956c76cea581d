#!/usr/bin/env python3
"""Generate the combine tables of csrc/fp12.cu.

Each output coefficient of the Fp12 product (K8), the Fp12 square (K9),
the cyclotomic square (K10), the power's product step and the sparse line
product (K11) is a signed sum of the Fp products (or Fp2 product components) its product
phase wrote to shared memory.  This script runs each combine's algebra (the algebra of
fields/fused.py's plain versions) on linear forms over those products and
prints, per output, the products it adds and the ones it subtracts (a
product twice where its coefficient is 2), as C tables.  The kernels run
one loop over such a row, the same instructions on every thread of a
warp whatever its output.

    python3 tools/fp12_tables.py        # prints the tables' C source
"""

from __future__ import annotations

import collections


class Lin(collections.Counter):
    """A linear form: product index -> integer coefficient."""

    def __add__(self, o):
        r = Lin(self)
        for k, v in o.items():
            r[k] += v
        return r

    def __sub__(self, o):
        r = Lin(self)
        for k, v in o.items():
            r[k] -= v
        return r


def leaf(i):
    return Lin({i: 1})


def xi(x):
    """xi (x0 + x1 i) = (x0 - x1) + (x0 + x1) i."""
    return (x[0] - x[1], x[0] + x[1])


def add2(x, y):
    return (x[0] + y[0], x[1] + y[1])


def sub2(x, y):
    return (x[0] - y[0], x[1] - y[1])


def fp6_combine(t):
    """The Fp6 Karatsuba combine of the Fp2 products t0, t1, t2, m01, m12,
    m02 (fields/fused.py `fp6_combine`)."""
    t0, t1, t2, m01, m12, m02 = t
    c0 = add2(t0, xi(sub2(sub2(m12, t1), t2)))
    c1 = add2(sub2(sub2(m01, t0), t1), xi(t2))
    c2 = add2(sub2(sub2(m02, t0), t2), t1)
    return (c0, c1, c2)


def fp12_kara(t0, t1, m):
    """t0 + v t1 + (m - t0 - t1) w as 12 Fp coefficients, output
    o = 6 half + 2 c + f."""
    vt1 = (xi(t1[2]), t1[0], t1[1])
    half0 = [add2(t0[c], vt1[c]) for c in range(3)]
    half1 = [sub2(sub2(m[c], t0[c]), t1[c]) for c in range(3)]
    return [x[f] for h in (half0, half1) for x in h for f in range(2)]


def sqr_forms():
    """K9: x^2 = t - m - v m + 2 m w over its 36 Fp products
    T[18 k + 3 p + kk] (pair p of Fp6 product k, t = (a + b)(a + v b) or
    m = a b; re = T0 - T1, im = T2 - T0 - T1): the 12 outputs."""
    P = [(leaf(3 * p) - leaf(3 * p + 1), leaf(3 * p + 2) - leaf(3 * p) - leaf(3 * p + 1))
         for p in range(12)]
    t, m = fp6_combine(P[:6]), fp6_combine(P[6:])
    vm = (xi(m[2]), m[0], m[1])
    half0 = [sub2(sub2(t[c], m[c]), vm[c]) for c in range(3)]
    half1 = [add2(m[c], m[c]) for c in range(3)]
    return [x[f] for h in (half0, half1) for x in h for f in range(2)]


def usqr_forms():
    """K10: output o is 3 u_o -/+ 2 x_o (minus for o < 6); u_o over the 18
    products Q[2 s + k] of the squares s = 3 g + j (X_j^2, Y_j^2,
    (X_j + Y_j)^2), coefficient k of each."""
    sq = [[(leaf(2 * (3 * g + j)), leaf(2 * (3 * g + j) + 1)) for j in range(3)]
          for g in range(3)]
    cross = [sub2(sub2(sq[2][j], sq[0][j]), sq[1][j]) for j in range(3)]
    u = [add2(xi(sq[0][c]), sq[1][c]) for c in range(3)]
    t = [xi(cross[2]), cross[0], cross[1]]
    return [x[f] for h in (u, t) for x in h for f in range(2)]


def cyc_mul_forms():
    """The power's product step: the 12 outputs over its 18 Fp2 products,
    component g of product pp = 6 k + p at 2 pp + g."""
    fp6 = [fp6_combine([(leaf(2 * (6 * k + p)), leaf(2 * (6 * k + p) + 1)) for p in range(6)])
           for k in range(3)]
    return fp12_kara(*fp6)


def mul_forms():
    """K8: the 12 outputs over its 54 Fp products T[18 k + 3 p + kk] (pair p
    of Fp6 product k, a c, b d or (a + b)(c + d); re = T0 - T1,
    im = T2 - T0 - T1)."""
    P = [(leaf(3 * p) - leaf(3 * p + 1), leaf(3 * p + 2) - leaf(3 * p) - leaf(3 * p + 1))
         for p in range(18)]
    return fp12_kara(*(fp6_combine(P[6 * k:6 * k + 6]) for k in range(3)))


def sparse_forms():
    """K11: the 12 outputs over the 45 Fp products T[3 p + k] of its 15 Fp2
    products (re = T0 - T1, im = T2 - T0 - T1)."""
    P = [(leaf(3 * p) - leaf(3 * p + 1), leaf(3 * p + 2) - leaf(3 * p) - leaf(3 * p + 1))
         for p in range(15)]
    t0 = (P[0], P[1], P[2])
    t1 = (xi(add2(P[3], P[4])), add2(P[5], xi(P[6])), add2(P[7], P[8]))
    m = fp6_combine(P[9:15])
    return fp12_kara(t0, t1, m)


def signed_rows(forms):
    """Per form, the products it adds and the ones it subtracts, a product
    listed as often as its coefficient says."""
    return [([k for k, v in sorted(f.items()) for _ in range(max(v, 0))],
             [k for k, v in sorted(f.items()) for _ in range(max(-v, 0))]) for f in forms]


def split_rows(rows, n: int):
    """Each row's added and subtracted products dealt out to n partial rows
    (row n_part * len(rows) + o of the result is part n_part of row o), so
    that n threads sum an output's terms in a third of the steps each."""
    return [(pos[part::n], neg[part::n]) for part in range(n) for pos, neg in rows]


def table(name: str, rows, what: str) -> str:
    """The C source of one table: per output the products added, then the
    ones subtracted, each padded to the longest row with 255."""
    n_pos = max(len(p) for p, _ in rows)
    n_neg = max(len(n) for _, n in rows)

    def arr(xs, n):
        return "{" + ", ".join(str(x) for x in xs + [255] * (n - len(xs))) + "}"

    n = len(rows)
    out = [f"// {name}: per output, the {what} it adds and subtracts",
           f"constexpr int {name}_POS = {n_pos}, {name}_NEG = {n_neg};",
           f"__device__ const uint8_t {name}_ADD[{n}][{n_pos}] = {{"]
    out += [f"    {arr(p, n_pos)}," for p, _ in rows]
    out += ["};", f"__device__ const uint8_t {name}_SUB[{n}][{n_neg}] = {{"]
    out += [f"    {arr(n, n_neg)}," for _, n in rows]
    out += ["};"]
    return "\n".join(out)


def main() -> None:
    print("// Generated by tools/fp12_tables.py; each row's signed sum is the output.")
    sqr = signed_rows(sqr_forms())
    print(table("SQR", sqr, "Fp products T[18 k + 3 p + kk]"))
    print(table("SQR3", split_rows(sqr, 3), "Fp products T[18 k + 3 p + kk] (SQR's rows in thirds)"))
    print(table("USQR", signed_rows(usqr_forms()),
                "square coefficients Q[2 s + k] (times 3, then -/+ 2 x_o)"))
    print(table("CYCMUL", signed_rows(cyc_mul_forms()), "Fp2 product components W[2 pp + g]"))
    print(table("SPARSE", signed_rows(sparse_forms()), "Fp products T[3 p + k]"))
    print(table("MUL3", split_rows(signed_rows(mul_forms()), 3),
                "Fp products T[18 k + 3 p + kk] (K8's rows in thirds)"))


if __name__ == "__main__":
    main()
