"""Sparse approximate Cholesky machinery for SANSA (Spišák et al., RecSys'23).

The port's own copy of ``cornac_tpu/ops/sparse_chol.py`` (a host numpy /
scipy module), kept line for line so that SANSA's factors are the JAX
package's bit for bit: an LDL^T factorization of the (permuted, optionally
equilibrated) item-item Gramian with on-the-fly pruning to a target
density, followed by a uniform-minimal-residual (UMR) approximate inverse
of the unit lower-triangular factor.

- Factorization and inversion are one-time set-up computations with a
  sequential dependency chain (column k depends on columns < k), so they run
  on the host in float64, where the reference's CHOLMOD/ICF run; the
  resulting sparse factors are what SANSA scores with on the card.
- **Scale ceiling**: the factorization works on a dense permuted Gramian
  (O(n_items^2) host memory, ~20 GB at 50K items in float64), which bounds
  it to catalogs of roughly <=30K items; ``models/sansa.py`` enforces the
  gate.
- ``icf_ldlt`` is a blocked left-looking LDL^T that prunes each computed
  column to the per-column budget before it is ever used by later columns
  ("pruning on-the-fly", the ICF semantics). Breakdown (non-positive pivot)
  triggers the reference's diagonal-shift escalation:
  ``shift_step * shift_multiplier**(k-1)`` on the k-th retry.
- ``exact_ldlt_pruned`` is the CHOLMOD-semantics path: exact factorization
  followed by pruning.
- ``umr_inverse`` repairs an initial Neumann guess of L^{-1} with
  column-wise minimal-residual scans (all columns) plus finetune steps
  (worst-residual columns only), re-pruning after every update.
"""

import numpy as np
import scipy.sparse as sp


class CholeskyBreakdown(RuntimeError):
    """Incomplete factorization hit a non-positive pivot."""


def rcm_permutation(pattern):
    """Fill-reducing ordering (reverse Cuthill-McKee) of a symmetric
    sparsity pattern. Returns the permutation array ``p`` such that the
    factorized matrix is ``A[p][:, p]``."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee(sp.csr_matrix(pattern), symmetric_mode=True),
        dtype=np.int64,
    )


def equilibrate_columns(gram_diag_norms):
    """ICF preprocessing scale: fourth root of the Gramian's column norms
    (columns of X are divided by this, so the scaled Gramian is
    ``diag(1/da) @ A @ diag(1/da)``)."""
    da = np.sqrt(np.sqrt(gram_diag_norms))
    da[da == 0] = 1.0
    return da


def _prune_column(w, keep):
    """Zero all but the ``keep`` largest-magnitude entries of ``w`` in
    place."""
    if keep <= 0:
        w[:] = 0.0
    elif keep < w.size:
        drop = np.argpartition(np.abs(w), w.size - keep)[: w.size - keep]
        w[drop] = 0.0
    return w


def _icf_attempt(A, keep, block=64):
    """One blocked left-looking LDL^T pass with per-column pruning.

    ``A`` is a dense float64 symmetric matrix (regularization already on the
    diagonal). Returns (L_unit, d) with L unit lower triangular holding at
    most ``keep`` nonzeros per column (including the unit diagonal).
    Raises CholeskyBreakdown on a non-positive pivot.
    """
    n = A.shape[0]
    L = np.zeros((n, n), dtype=np.float64)
    d = np.zeros(n, dtype=np.float64)
    tiny = 1e-12 * max(float(A.diagonal().max()), 1.0)
    off_keep = max(0, keep - 1)  # diagonal always occupies one slot
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        # panel update from all previously finished column blocks (BLAS3)
        panel = A[j0:n, j0:j1].copy()
        if j0:
            panel -= L[j0:n, :j0] @ (d[None, :j0] * L[j0:j1, :j0]).T
        for t in range(j1 - j0):
            j = j0 + t
            col = panel[t:, t]
            if t:
                col = col - L[j:n, j0:j] @ (d[j0:j] * L[j, j0:j])
            piv = float(col[0])
            if piv <= tiny:
                raise CholeskyBreakdown(f"pivot {piv:.3e} at column {j}")
            d[j] = piv
            L[j, j] = 1.0
            if j + 1 < n:
                w = col[1:] / piv
                L[j + 1 : n, j] = _prune_column(w, off_keep)
    return L, d


def icf_ldlt(A, density, shift_step=1e-3, shift_multiplier=2.0, max_retries=30,
             verbose=False):
    """Incomplete Cholesky (LDL^T) with on-the-fly pruning and the
    reference's breakdown-shift escalation.

    Parameters mirror ``ICFGramianFactorizerConfig`` (reference
    ``recom_sansa.py:145-148``). ``A`` is the dense regularized Gramian.
    Returns (L_unit csc, d) pruned to ``density``.
    """
    n = A.shape[0]
    keep = max(1, int(np.ceil(density * n)))
    work = np.array(A, dtype=np.float64)  # single working copy; retries only
    applied = 0.0                         # touch its diagonal in place
    diag_idx = np.diag_indices(n)
    for attempt in range(max_retries + 1):
        try:
            L, d = _icf_attempt(work, keep)
            return sp.csc_matrix(L), d
        except CholeskyBreakdown:
            if attempt == max_retries:
                raise
            shift = shift_step * (shift_multiplier ** attempt)
            work[diag_idx] += shift - applied
            applied = shift
            if verbose:
                print(f"ICF breakdown; retrying with diagonal shift {shift:g}")


def exact_ldlt_pruned(A, density):
    """CHOLMOD-semantics path: exact dense factorization followed by
    pruning (reference ``recom_sansa.py:143``: "exact Cholesky ... followed
    by pruning")."""
    n = A.shape[0]
    keep = max(1, int(np.ceil(density * n)))
    Lc = np.linalg.cholesky(A)
    dd = np.diag(Lc).copy()
    d = dd * dd
    L = Lc / dd[None, :]
    off_keep = max(0, keep - 1)
    for j in range(n - 1):
        _prune_column(L[j + 1 :, j], off_keep)
    return sp.csc_matrix(L), d


def _prune_csc_columns(M, keep, cols=None):
    """Keep the ``keep`` largest-magnitude entries per column of CSC ``M``
    (the diagonal entry is always kept). Returns a new CSC matrix."""
    M = M.tocsc()
    n = M.shape[1]
    data, indices, indptr = M.data, M.indices, M.indptr
    new_data, new_indices, new_indptr = [], [], [0]
    col_set = None if cols is None else set(int(c) for c in cols)
    for j in range(n):
        lo, hi = indptr[j], indptr[j + 1]
        dj, ij = data[lo:hi], indices[lo:hi]
        if (col_set is None or j in col_set) and dj.size > keep and keep > 0:
            mag = np.abs(dj)
            mag = np.where(ij == j, np.inf, mag)  # protect the diagonal
            sel = np.argpartition(mag, dj.size - keep)[dj.size - keep :]
            sel = np.sort(sel)
            dj, ij = dj[sel], ij[sel]
        nz = dj != 0
        dj, ij = dj[nz], ij[nz]
        new_data.append(dj)
        new_indices.append(ij)
        new_indptr.append(new_indptr[-1] + dj.size)
    return sp.csc_matrix(
        (
            np.concatenate(new_data) if new_data else np.empty(0),
            np.concatenate(new_indices) if new_indices else np.empty(0, np.int32),
            np.asarray(new_indptr),
        ),
        shape=M.shape,
    )


def _project_unit_lower(M):
    """Project onto unit-lower-triangular structure (L^{-1} of a unit lower
    triangular matrix is unit lower triangular)."""
    M = sp.tril(M, k=-1).tocsc()
    return (M + sp.identity(M.shape[0], format="csc")).tocsc()


def umr_inverse(L, density, scans=3, finetune_steps=10, finetune_frac=0.1):
    """Approximate inverse of unit lower triangular ``L`` by minimal-residual
    iteration with per-column pruning.

    ``scans`` full passes update every column; ``finetune_steps`` passes
    update only the worst ``finetune_frac`` of columns by residual norm
    (reference ``UMRUnitLowerTriangleInverterConfig`` semantics,
    ``recom_sansa.py:152-156``).
    """
    L = sp.csc_matrix(L)
    n = L.shape[0]
    keep = max(1, int(np.ceil(density * n)))
    eye = sp.identity(n, format="csc")
    # initial guess: first Neumann term  L^{-1} ~ I - N,  N = L - I
    M = _prune_csc_columns((2.0 * eye - L).tocsc(), keep)

    def mr_step(M, cols=None):
        R = (eye - L @ M).tocsc()
        if cols is not None:
            # restrict the residual to the selected COLUMNS: CSC indices are
            # row ids, so derive each nonzero's column from indptr
            mask = np.zeros(n, dtype=bool)
            mask[cols] = True
            col_of = np.repeat(np.arange(n), np.diff(R.indptr))
            keep_cols = np.where(mask[col_of], R.data, 0.0)
            R = sp.csc_matrix((keep_cols, R.indices.copy(), R.indptr.copy()),
                              shape=R.shape)
            R.eliminate_zeros()
        LR = (L @ R).tocsc()
        num = np.asarray(R.multiply(LR).sum(axis=0)).ravel()
        den = np.asarray(LR.multiply(LR).sum(axis=0)).ravel()
        alpha = np.where(den > 0, num / np.maximum(den, 1e-300), 0.0)
        M = (M + R @ sp.diags(alpha)).tocsc()
        M = _project_unit_lower(M)
        return _prune_csc_columns(M, keep, cols=cols)

    for _ in range(int(scans)):
        M = mr_step(M)
    n_fine = max(1, int(np.ceil(finetune_frac * n)))
    for _ in range(int(finetune_steps)):
        R = eye - L @ M
        res = np.asarray(R.multiply(R).sum(axis=0)).ravel()
        worst = np.argpartition(res, n - n_fine)[n - n_fine:]
        if res[worst].max() <= 1e-24:
            break
        M = mr_step(M, cols=worst)
    return M
