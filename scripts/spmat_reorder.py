#!/usr/bin/env python
"""Reorder a sparse matrix file (RCM / random / natural) and rewrite it.

Equivalent of the reference's scripts/spmat_reorder.py: loads any
supported matrix format, applies a symmetric permutation, and writes the
result back in IJ ASCII or binary form (with the permuted RHS when
given).  Bandwidth reduction helps blocked SpMV locality on the device just as
it helps cache locality on CPU.

Usage:
  python scripts/spmat_reorder.py A.ij -o A_rcm.ij --method rcm
  python scripts/spmat_reorder.py A.bin -b rhs.bin -o out_prefix --binary
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matrix")
    ap.add_argument("-b", "--rhs", default=None)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--method", choices=("rcm", "random", "natural"),
                    default="rcm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--binary", action="store_true")
    args = ap.parse_args(argv)

    from scipy.sparse.csgraph import reverse_cuthill_mckee
    import scipy.sparse as sp
    from hypredrive_tpu.io import ij

    A, ilower = ij.read_matrix_auto(args.matrix)
    n = A.shape[0]
    if args.method == "rcm":
        perm = reverse_cuthill_mckee(A, symmetric_mode=True)
    elif args.method == "random":
        perm = np.random.default_rng(args.seed).permutation(n)
    else:
        perm = np.arange(n)

    def bandwidth(M):
        coo = M.tocoo()
        return int(np.abs(coo.row - coo.col).max()) if M.nnz else 0

    B = sp.csr_matrix(A[perm][:, perm])
    print(f"{args.matrix}: n={n} nnz={A.nnz} "
          f"bandwidth {bandwidth(A)} -> {bandwidth(B)} ({args.method})")

    if args.binary:
        ij.write_matrix_multipart(args.output, B, n_parts=1)
    else:
        ij.write_matrix_ascii(args.output, B, ilower=ilower)
    if args.rhs:
        rhs = ij.read_vector_auto(args.rhs)[perm]
        out_b = args.output + ".b"
        if args.binary:
            ij.write_vector_multipart(out_b, rhs, n_parts=1)
        else:
            ij.write_vector_ascii(out_b, rhs, ilower=ilower)
        print(f"wrote permuted RHS to {out_b}")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
