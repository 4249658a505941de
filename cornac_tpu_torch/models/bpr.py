"""BPR — Bayesian Personalized Ranking (Rendle et al., UAI 2009) + WBPR.

Port of ``cornac_tpu/models/bpr.py``: the constructor, seeded
initialisation, the trainer, and every scoring and vector method. Factors
are persisted as numpy, as in the JAX package; their device copies are
process-local and rebuilt on demand.

The trainer is ``_bpr_epochs`` written as eager torch on the model's
device. Each epoch draws |R| triplets from a ``torch.Generator`` seeded from
(the fit's seed, the global epoch index), in one bulk draw or, above
``_BULK_SAMPLING_MAX`` samples, per minibatch; rejects observed negatives
through ``ops.membership`` by masking them out of the update (skip, not
resample); and applies minibatched SGD whose row updates go through the
deterministic ``ops.accumulate.accumulate_rows``. The item bias rides as an
extra column of V, with a frozen column of ones in U. Nothing syncs with
the host inside an epoch. The JAX package's TPU layouts (the fused one-hot
fetch with membership halfwords, the 64-column padding, the b+tree) change
only the float summation order and are not copied; ``fused_fetch`` is
accepted and ignored.

``mesh`` (``parallel.make_mesh``) trains data- and model-parallel, one
process a rank, and keeps the single-device fit's bits. The extended tables
are row-sharded over "model" (padded to the shard count; padded rows are
never drawn and are cut off). Every rank draws the same global stream, so
the stream is the single-device fit's. The rank with data index d takes
slice d of each minibatch (``parallel.sharded.batch_slice``), fetches its
rows with ``row_shard_lookup`` and computes its slice's update rows with
``_bpr_updates``, the single-device step's arithmetic. The update rows are
all-gathered over "data" in slice order, which is the batch order, and each
rank applies those of its rows with ``row_shard_scatter_add``: each row
receives the single-device fit's float additions, in its order. The
``correct`` counts of the slices are summed over "data". Every rank ends
with the whole numpy factors.
"""

import functools

import numpy as np
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.membership import build_membership
from ..parallel.mesh import check_mesh, shard_tables
from ..parallel.sharded import (
    all_sum,
    batch_slice,
    gather_batch,
    local_shard,
    row_shard_lookup,
    row_shard_scatter_add,
)
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import uniform, zeros
from .recommender import ANNMixin, MEASURE_DOT, Recommender

DTYPE = np.float32

# Above this many samples per epoch (|R| padded to whole minibatches),
# triplets are drawn per minibatch instead of in one bulk draw per epoch,
# which bounds the sampling tensors by batch_size instead of |R|. Read at
# call time, so tests may lower it.
_BULK_SAMPLING_MAX = 1 << 24


def _dot_scores(U, V, Bi, users):
    return Bi[None, :] + U[users] @ V.T


def _extended_tables(U, V, Bi, use_bias, device):
    """(U, V, gate) on ``device``, copies the trainer updates in place: with
    the bias, U gains a column of ones and V the bias column, so one dot
    product holds both; ``gate`` (1, k') zeroes the update of U's ones
    column."""
    U = torch.tensor(np.asarray(U, np.float32), device=device)
    V = torch.tensor(np.asarray(V, np.float32), device=device)
    gate = torch.ones((1, U.shape[1] + int(use_bias)), dtype=torch.float32, device=device)
    if use_bias:
        U = torch.cat([U, torch.ones((U.shape[0], 1), dtype=U.dtype, device=device)], 1)
        V = torch.cat([V, torch.tensor(np.asarray(Bi, np.float32), device=device)[:, None]], 1)
        gate[0, -1] = 0.0
    return U, V, gate


def _bpr_draws(gen, n, n_total, batch_size, num_items, neg_population):
    """An epoch's draws from ``gen``: (positive pair index, negative item)
    tensors, one (n_total,) pair for bulk sampling, or one (batch_size,)
    pair per minibatch above ``_BULK_SAMPLING_MAX``. Negatives are uniform
    over the catalog, or uniform over ``neg_population`` (WBPR)."""
    size = batch_size if n_total > _BULK_SAMPLING_MAX else n_total
    dev = gen.device
    for _ in range(n_total // size):
        pos_idx = torch.randint(n, (size,), generator=gen, device=dev)
        if neg_population is None:
            neg_items = torch.randint(num_items, (size,), generator=gen, device=dev)
        else:
            neg_items = neg_population[
                torch.randint(neg_population.shape[0], (size,), generator=gen, device=dev)]
        yield pos_idx, neg_items


def _bpr_updates(wu, vi, vj, m, lr, reg, gate, variant):
    """The update rows of a minibatch (or of a data slice of one) from its
    fetched rows: (U's rows, V's rows for the positives, V's rows for the
    negatives, the number of valid triplets already ordered correctly)."""
    diff = vi - vj
    x = (wu * diff).sum(1)
    mf = m.to(wu.dtype)
    if variant == "hinge":
        # max-margin (MMMF): update only misordered pairs, with unit
        # magnitude and no regularisation otherwise
        upd = mf * (x <= 0)
        z = upd
    else:
        upd = mf
        z = mf / (1.0 + torch.exp(x))  # d(-ln sigmoid(x))/dx
    z, upd = z[:, None], upd[:, None]
    zw = z * wu
    return (lr * ((z * diff - reg * wu * upd) * gate), lr * (zw - reg * vi * upd),
            lr * (-zw - reg * vj * upd), ((x > 0) & m).sum())


def _bpr_step(U, V, u, i, j, m, lr, reg, gate, variant):
    """One minibatch of SGD on the extended tables, in place. Returns the
    number of valid triplets already ordered correctly (a device scalar)."""
    d_u, d_i, d_j, correct = _bpr_updates(U[u], V[i], V[j], m, lr, reg, gate, variant)
    accumulate_rows(U, u, d_u)
    accumulate_rows(V, torch.cat([i, j]), torch.cat([d_i, d_j]))
    return correct


def _bpr_step_sharded(mesh, U, V, u, i, j, m, lr, reg, gate, variant):
    """``_bpr_step`` on a mesh: U and V are this rank's row shards, (u, i,
    j, m) the whole minibatch. This rank computes the update rows of its
    data slice; the slices are gathered back in batch order and each rank
    applies those of its rows. Returns the slice's ``correct`` count."""
    B = u.shape[0]
    lo, hi, per = batch_slice(mesh, B)
    wu = row_shard_lookup(mesh, U, u[lo:hi])
    vij = row_shard_lookup(mesh, V, torch.cat([i[lo:hi], j[lo:hi]]))
    d_u, d_i, d_j, correct = _bpr_updates(wu, vij[:hi - lo], vij[hi - lo:], m[lo:hi], lr, reg,
                                          gate, variant)
    k = d_u.shape[1]
    rows = gather_batch(mesh, torch.cat([d_u, d_i, d_j], 1), B, per)
    row_shard_scatter_add(mesh, U, u, rows[:, :k].contiguous())
    row_shard_scatter_add(mesh, V, torch.cat([i, j]),
                          torch.cat([rows[:, k:2 * k], rows[:, 2 * k:]]))
    return correct


def _bpr_epoch(U, V, draws, pairs, membership, n, lr, reg, batch_size, gate, variant,
               step=_bpr_step):
    """One epoch of BPR on given draws, updating the extended tables U and V
    in place. ``draws``: (positive pair index, negative item) tensors, as
    ``_bpr_draws`` yields them, covering ``n_total`` (|R| padded to whole
    minibatches) samples; ``pairs``: (|R|, 2) int64 (user, item) rows.
    Samples past |R|, negatives equal to the positive and observed
    negatives are skipped. ``step``: ``_bpr_step``, or the mesh's
    ``_bpr_step_sharded`` bound to its mesh. Returns (correct, skipped)
    device scalars."""
    correct = torch.zeros((), dtype=torch.int64, device=U.device)
    skipped = torch.zeros((), dtype=torch.int64, device=U.device)
    start = 0
    for pos_idx, neg_items in draws:
        users, items = pairs[pos_idx].unbind(1)
        padm = torch.arange(start, start + pos_idx.shape[0], device=U.device) < n
        valid = (items != neg_items) & padm & ~membership.query(users, neg_items)
        skipped += (padm & ~valid).sum()
        for s in range(0, pos_idx.shape[0], batch_size):
            sl = slice(s, s + batch_size)
            correct += step(U, V, users[sl], items[sl], neg_items[sl], valid[sl],
                            lr, reg, gate, variant)
        start += pos_idx.shape[0]
    return correct, skipped


class BPR(Recommender, ANNMixin):
    """BPR recommender with deterministic minibatch SGD on the device.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_reg``, ``use_bias``, ``init_params``
    ({'U','V','Bi'}), ``seed``, ``batch_size``. ``device``: where the model
    trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``, the
    tables are row-sharded over "model" and each minibatch split over
    "data", and the factors equal the single-device fit's (module
    docstring).
    """

    def __init__(
        self,
        name="BPR",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_reg=0.01,
        use_bias=True,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.k = int(k)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lambda_reg = lambda_reg
        self.use_bias = use_bias
        # reference OpenMP knob, accepted so reference scripts run unchanged
        self.num_threads = num_threads
        self.batch_size = batch_size
        self.seed = seed
        self.rng = get_rng(seed)

        self.init_params = {} if init_params is None else init_params
        self.u_factors = self.init_params.get("U", None)
        self.i_factors = self.init_params.get("V", None)
        self.i_biases = self.init_params.get("Bi", None)
        self.ignored_attrs.append("_factors_d")

    _variant = "bpr"

    def _init(self):
        # full-table init over total entities: unknown users/items keep
        # their initial vectors, as in the JAX package
        n_users, n_items = self.total_users, self.total_items
        if self.u_factors is None:
            self.u_factors = (
                uniform((n_users, self.k), random_state=self.rng, dtype=DTYPE) - 0.5
            ) / self.k
        if self.i_factors is None:
            self.i_factors = (
                uniform((n_items, self.k), random_state=self.rng, dtype=DTYPE) - 0.5
            ) / self.k
        if self.i_biases is None or self.use_bias is False:
            self.i_biases = zeros(n_items, dtype=DTYPE)

    def _neg_population(self, train_set, device):
        """Tensor of candidate negatives on ``device``, or None for uniform."""
        return None

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if not self.trainable:
            return self

        mesh = self.mesh
        dev = self._device()
        rid, cid, _ = train_set.uir_tuple
        n = len(rid)
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        neg_pop = self._neg_population(train_set, dev)
        U, V, gate = _extended_tables(self.u_factors, self.i_factors, self.i_biases,
                                      self.use_bias, dev)
        n_u, n_i = U.shape[0], V.shape[0]
        step = _bpr_step
        if mesh is not None:
            U, V = shard_tables(mesh, U, V)  # DTensors: what a checkpoint gathers
            step = functools.partial(_bpr_step_sharded, mesh)
        seed = self.rng.randint(2**31)
        batch_size = min(self.batch_size, n)
        n_total = n + (-n) % batch_size

        def run_chunk(state, start, e):
            U, V = (local_shard(t) for t in state)
            for epoch in range(start, start + e):
                draws = _bpr_draws(epoch_generator(seed, epoch, dev), n, n_total, batch_size,
                                   train_set.num_items, neg_pop)
                info = _bpr_epoch(U, V, draws, pairs, membership, n, self.learning_rate,
                                  self.lambda_reg, batch_size, gate, self._variant, step)
            if mesh is not None:
                info = (all_sum(mesh, info[0]), info[1])
            return state, info

        def report(done, info):
            correct, skipped = int(info[0]), int(info[1])
            print(
                "Epoch %d/%d, correct: %.2f%%, skipped: %.2f%%"
                % (done, self.max_iter, 100.0 * correct / (n - skipped + 1e-8),
                   100.0 * skipped / n)
            )

        epoch_loop(self, self.max_iter, run_chunk, (U, V), on_report=report)
        if mesh is not None:
            U, V = U.full_tensor()[:n_u], V.full_tensor()[:n_i]

        k = self.k
        self.u_factors = U[:, :k].cpu().numpy()
        self.i_factors = V[:, :k].cpu().numpy()
        if self.use_bias:
            self.i_biases = V[:, k].cpu().numpy()

        if self.verbose:
            print("Optimization finished!")

        return self

    def _device_factors(self):
        """(U, V, Bi) float32 tensors on the model's device, rebuilt when
        the numpy factors were replaced or the device changed."""
        dev = self._device()
        srcs = (self.u_factors, self.i_factors, self.i_biases)
        cached = getattr(self, "_factors_d", None)
        if (
            cached is None
            or cached[0] != dev
            or any(a is not b for a, b in zip(cached[1], srcs))
        ):
            tensors = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in srcs
            )
            cached = self._factors_d = (dev, srcs, tensors)
        return cached[2]

    # ------------------------------------------------------------------ #
    # scoring
    # ------------------------------------------------------------------ #
    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            return self.i_biases + self.i_factors @ self.u_factors[user_idx]
        return self.i_biases[item_idx] + np.dot(
            self.u_factors[user_idx], self.i_factors[item_idx]
        )

    def score_batch(self, user_indices):
        return self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)

    def score_batch_device(self, user_indices):
        U, V, Bi = self._device_factors()
        users = torch.as_tensor(np.asarray(user_indices), dtype=torch.long, device=U.device)
        return _dot_scores(U, V, Bi, users)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        return self.i_biases[items] + np.sum(
            self.u_factors[users] * self.i_factors[items], axis=1
        )

    # ------------------------------------------------------------------ #
    # ANN vectors
    # ------------------------------------------------------------------ #
    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return np.concatenate(
            (self.u_factors, np.ones([self.u_factors.shape[0], 1])), axis=1
        )

    def get_item_vectors(self):
        return np.concatenate(
            (self.i_factors, self.i_biases.reshape((-1, 1))), axis=1
        )


class WBPR(BPR):
    """Weighted BPR (Gantner et al.): negatives sampled by popularity."""

    def __init__(
        self,
        name="WBPR",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_reg=0.01,
        use_bias=True,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            max_iter=max_iter,
            learning_rate=learning_rate,
            lambda_reg=lambda_reg,
            use_bias=use_bias,
            num_threads=num_threads,
            batch_size=batch_size,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )

    def _neg_population(self, train_set, device):
        # uniform over the interaction item array: items in proportion to
        # their train-set frequency
        return torch.as_tensor(np.asarray(train_set.uir_tuple[1], np.int64), device=device)
