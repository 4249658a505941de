"""WMF — Weighted Matrix Factorization (Hu, Koren & Volinsky, ICDM 2008).

Port of ``cornac_tpu/models/wmf.py``: alternating least squares on the
model's device. Each half sweep re-solves every entity of one side: for an
entity with observed rows v_j of the other side's factors (preferences
p_j, confidence a observed and b unobserved),
A = b·G + (a − b)·Σ v_j v_jᵀ + λ·I and x = A⁻¹ (a·Σ p_j v_j), with
G = FᵀF of the whole other side. The sums are batched products over padded
CSR rows and the k x k systems one batched ``torch.linalg.solve_ex``: plain
PyTorch, as XLA does them in the JAX package. The initial factors are
numpy's (``xavier_uniform``), so a fit is deterministic and the same in
both packages up to the order of float32 sums.

The rows are bucketed by degree, as ``cornac_tpu/models/wmf.py``'s
``_bucketed_csr``: entities sorted by degree and bucketed, each bucket
padded to its own largest degree and cut into chunks sized so that the
(chunk, L, k) gather stays under a workspace budget, whatever the catalog's
largest degree. The JAX package's other layout, every row padded to the
largest degree, serves its mesh path and waits for it here (ROADMAP.md A8).
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.dispatch import full_f32
from ..utils import get_rng
from ..utils.checkpoint import epoch_loop
from ..utils.init_utils import xavier_uniform
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog

_BUCKET_WORKSPACE_BYTES = 256 * 1024 * 1024
_BUCKET_MAX_WIDTH = 8192


def _solve_chunk(F_other, G, idx, val, mask, a, b, lamb):
    """The ALS solves of one chunk of entities: ``idx``, ``val``, ``mask``
    (C, L) are their padded rows. Returns (C, k)."""
    k = F_other.shape[1]
    Vs = F_other[idx] * mask[:, :, None]  # (C, L, k)
    VsT = Vs.transpose(1, 2)
    with full_f32():
        A = b * G[None] + (a - b) * torch.bmm(VsT, Vs)
        rhs = a * torch.bmm(VsT, (val * mask)[:, :, None])
    A = A + lamb * torch.eye(k, dtype=A.dtype, device=A.device)[None]
    return torch.linalg.solve_ex(A, rhs)[0].squeeze(-1)  # no check, so no sync


def _gram(F):
    with full_f32():
        return F.T @ F


def _bucketed_csr(csr, k, device, budget=None):
    """Degree-aware chunking, as ``cornac_tpu/models/wmf.py::_bucketed_csr``:
    entities sorted by degree, bucketed at powers of two, each bucket padded
    to its largest degree (rounded up to 8) and cut into chunks of width w so
    that the (w, L, k) float32 gather stays under ``budget`` bytes. Returns a
    list of (idx, val, mask, ids) per bucket: (n_chunks, w, L) tensors and
    (n_chunks * w,) entity ids on ``device``; padded entities carry id n
    (the solves scatter into n + 1 rows and drop the last)."""
    budget = _BUCKET_WORKSPACE_BYTES if budget is None else budget
    n = csr.shape[0]
    deg = np.diff(csr.indptr).astype(np.int64)
    order = np.argsort(-deg, kind="stable")
    degs_sorted = deg[order]
    groups = []
    start = 0
    while start < n:
        L = max(int(degs_sorted[start]), 1)
        L2 = 1 << (L - 1).bit_length()
        if L2 == 1:
            end = n  # the rest have degree 1 or 0: one last bucket
        else:
            end = start + int(np.searchsorted(-degs_sorted[start:], -(L2 // 2)))
            end = max(end, start + 1)
        L2 = -(-L // 8) * 8
        w = int(max(8, min(_BUCKET_MAX_WIDTH, budget // (L2 * k * 4))))
        ids = order[start:end]
        m = len(ids)
        w = min(w, m + (-m) % 8)
        n_pad = -(-m // w) * w
        d = deg[ids]
        rows = np.repeat(np.arange(m), d)
        cols = np.arange(len(rows)) - np.repeat(np.cumsum(d) - d, d)
        flat = np.repeat(csr.indptr[ids].astype(np.int64), d) + cols
        idx = np.zeros((n_pad, L2), np.int64)
        val = np.zeros((n_pad, L2), np.float32)
        mask = np.zeros((n_pad, L2), np.float32)
        idx[rows, cols] = csr.indices[flat]
        val[rows, cols] = csr.data[flat]
        mask[rows, cols] = 1.0
        out_ids = np.full(n_pad, n, np.int64)
        out_ids[:m] = ids
        shape = (n_pad // w, w, L2)
        groups.append(tuple(torch.as_tensor(x, device=device) for x in (
            idx.reshape(shape), val.reshape(shape), mask.reshape(shape), out_ids)))
        start = end
    return groups


def _solve_side_bucketed(F_other, groups, a, b, lamb, n_out):
    """Re-solve every entity of one side from its ``_bucketed_csr``
    buckets. Returns (n_out, k)."""
    G = _gram(F_other)
    out = torch.zeros((n_out + 1, F_other.shape[1]), dtype=F_other.dtype,
                      device=F_other.device)
    for idx, val, mask, ids in groups:
        sols = [_solve_chunk(F_other, G, *rows, a, b, lamb) for rows in zip(idx, val, mask)]
        out[ids] = torch.cat(sols)
    return out[:n_out]


def _als_sweeps_bucketed(U, V, u_groups, i_groups, a, b, lu, li, n_sweeps):
    """``n_sweeps`` ALS sweeps on the ``_bucketed_csr`` layout, as
    ``cornac_tpu/models/wmf.py::_als_fit_bucketed``. Returns (U, V)."""
    for _ in range(n_sweeps):
        U = _solve_side_bucketed(V, u_groups, a, b, lu, U.shape[0])
        V = _solve_side_bucketed(U, i_groups, a, b, li, V.shape[0])
    return U, V


class WMF(Recommender, ANNMixin):
    """WMF solved by ALS on the device.

    Parameters mirror the JAX package: ``k``, ``lambda_u``, ``lambda_v``,
    ``a`` and ``b`` (the confidences of observed and unobserved entries),
    ``max_iter`` (ALS sweeps), ``init_params`` ({'U','V'}), ``seed``;
    ``learning_rate`` and ``batch_size`` are kept for the API and not read
    by the single-device solver. ``device``: where the model trains and
    scores (default: the card). ``mesh`` is not ported yet.
    """

    def __init__(
        self,
        name="WMF",
        k=200,
        lambda_u=0.01,
        lambda_v=0.01,
        a=1,
        b=0.01,
        learning_rate=0.001,
        batch_size=128,
        max_iter=30,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
        self.device = device
        self.k = k
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.a = a
        self.b = b
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        if self.U is None:
            self.U = xavier_uniform((self.num_users, self.k), rng)
        if self.V is None:
            self.V = xavier_uniform((self.num_items, self.k), rng)

        dev = self._device()
        csr = train_set.csr_matrix
        u_groups = _bucketed_csr(csr, self.k, dev)
        i_groups = _bucketed_csr(csr.T.tocsr(), self.k, dev)
        state = tuple(torch.tensor(np.asarray(x, np.float32), device=dev)
                      for x in (self.U, self.V))
        consts = tuple(float(np.float32(x)) for x in (self.a, self.b, self.lambda_u,
                                                      self.lambda_v))

        def run_chunk(state, start, e):
            return _als_sweeps_bucketed(*state, u_groups, i_groups, *consts, e), None

        U, V = epoch_loop(self, self.max_iter, run_chunk, state,
                          on_report=lambda done, _: print("ALS sweep %d/%d"
                                                          % (done, self.max_iter)))
        self.U, self.V = U.cpu().numpy(), V.cpu().numpy()
        if self.verbose:
            print("ALS finished (%d sweeps)" % self.max_iter)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            return self.V @ self.U[user_idx]
        return self.V[item_idx].dot(self.U[user_idx])

    def _known_scores_device(self, safe_users, known):
        dev = self._device()
        U, V = (torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (self.U, self.V))
        users = torch.as_tensor(safe_users, dtype=torch.long, device=dev)
        known_d = torch.as_tensor(known.astype(np.float32), device=dev)
        with full_f32():
            return (U[users] * known_d[:, None]) @ V.T

    def score_batch(self, user_indices):
        scores = self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        preds = np.sum(self.U[np.where(known, users, 0)] * self.V[np.where(known, items, 0)],
                       axis=1)
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.V
