"""Dense eigenspectrum computation.

Reference: src/internal/eigspec.c — gathers A (or M⁻¹A via a precon-apply
callback) to a dense matrix on rank 0, runs dgeev/dsyev, writes
eigenvalues ASCII + eigenvectors binary.  Here: densify on host and
use jnp.linalg.eig/eigh (small systems only — the feature is explicitly a
diagnostic for modest n).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp


def compute_eigenspectrum(system, eig_args, precon=None):
    """Returns eigenvalues (and writes files per eig_args)."""
    A = np.asarray(system.A_host.todense())
    if eig_args.get("preconditioned") and precon is not None \
            and precon.apply_fn is not None:
        # columns of M⁻¹A via the precon apply — batched with vmap when
        # the apply is vmappable, else column-by-column
        try:
            Ad = jnp.asarray(A.T, system.dtype)  # rows = columns of A
            cols = jax.jit(jax.vmap(
                lambda v: precon.apply_fn(precon.state, v)))(Ad)
            A = np.asarray(cols).T
        except Exception:
            cols = []
            for j in range(A.shape[1]):
                cols.append(np.asarray(
                    precon.apply_fn(precon.state, jnp.asarray(A[:, j],
                                                              system.dtype))))
            A = np.stack(cols, axis=1)

    hermitian = bool(eig_args.get("hermitian"))
    want_vectors = bool(eig_args.get("vectors"))
    if hermitian:
        if want_vectors:
            w, v = np.linalg.eigh(A)
        else:
            w = np.linalg.eigvalsh(A)
            v = None
    else:
        if want_vectors:
            w, v = np.linalg.eig(A)
        else:
            w = np.linalg.eigvals(A)
            v = None

    prefix = eig_args.get("output_prefix") or "eigspec"
    with open(f"{prefix}_eigenvalues.txt", "w") as f:
        f.write(f"{len(w)}\n")
        for lam in w:
            if np.iscomplexobj(w):
                f.write(f"{lam.real:.15e} {lam.imag:.15e}\n")
            else:
                f.write(f"{lam:.15e}\n")
    if v is not None:
        np.asarray(v).astype(np.complex128 if np.iscomplexobj(v)
                             else np.float64).tofile(f"{prefix}_eigenvectors.bin")
    return w
