"""MF — biased Matrix Factorization (Koren et al., 2009) — and SVD.

Port of ``cornac_tpu/models/mf.py`` on its SGD path: the trainer is
``_mf_sgd_epochs`` written as eager torch on the model's device. Each epoch
visits every observed rating once in a fresh permutation from a
``torch.Generator`` seeded from (the fit's seed, the global epoch index), in
minibatches of gather -> error -> deterministic row updates
(``ops.accumulate.accumulate_rows``). The biases ride as extra factor
columns (U gains [Bu, 1], V gains [1, Bi]), so each step updates two tables.
``early_stop`` compares each epoch's loss on the host, through
``epoch_loop(max_chunk=1)``.

Another ``optimizer`` (``adam``, ``rmsprop``, ``adagrad``) or ``dropout > 0``
takes the general-optimizer path, ``_mf_optax_epoch``: per minibatch, autograd
through the gathered rows (``ops.accumulate.gather_rows``, whose gradient is
the deterministic ``accumulate_rows``), then the optax update rule written out
in ``ops.optim``, dense over the whole tables. The dropout masks come from the
epoch's generator, one pair per minibatch after the permutation, as the JAX
package folds the minibatch index into the epoch's key.

SVD is MF with the biases on, as in the JAX package.

``mesh`` (``parallel.make_mesh``) trains one process a rank and keeps the
single-device fit's bits, as BPR's branch does (``models/bpr.py``). On the
SGD path the extended tables are row-sharded over "model"; each rank draws
the same permutation, computes the update rows of its data slice of each
minibatch from rows fetched with ``row_shard_lookup``, and the slices'
rows (and errors, for the loss) are all-gathered over "data" in batch
order before ``row_shard_scatter_add``. On the general-optimizer path the
parameters are replicated, as in the JAX package: each rank takes the
gradient of its slice with respect to the gathered rows, the per-row
gradients are all-gathered in batch order and summed into the tables'
gradients by ``accumulate_rows`` as the single-device backward does, and
every rank applies the same optimizer update; the reported loss is the
whole minibatch's, computed on every rank.
"""

import functools

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows, gather_rows
from ..ops.dispatch import full_f32
from ..ops.optim import apply_updates, make_optimizer
from ..parallel.mesh import check_mesh, shard_tables
from ..parallel.sharded import (
    batch_slice,
    gather_batch,
    local_shard,
    row_shard_lookup,
    row_shard_scatter_add,
)
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import normal, zeros
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog

DTYPE = np.float32


def _extended_tables(U, V, Bu, Bi, use_bias, device):
    """(U, V, u_gate, v_gate) on ``device``, copies the trainer updates in
    place: with the biases, U gains the columns [Bu, 1] and V [1, Bi], so
    one dot product holds both biases; the gates zero the updates of the
    two columns of ones."""
    U, V, Bu, Bi = (torch.tensor(np.asarray(a, np.float32), device=device)
                    for a in (U, V, Bu, Bi))
    k = U.shape[1]
    if not use_bias:
        gate = torch.ones((1, k), dtype=torch.float32, device=device)
        return U, V, gate, gate
    U = torch.cat([U, Bu[:, None], torch.ones_like(Bu)[:, None]], 1)
    V = torch.cat([V, torch.ones_like(Bi)[:, None], Bi[:, None]], 1)
    u_gate = torch.ones((1, k + 2), dtype=torch.float32, device=device)
    v_gate = u_gate.clone()
    u_gate[0, k + 1] = 0.0
    v_gate[0, k] = 0.0
    return U, V, u_gate, v_gate


def _epoch_permutation(n, gen):
    """A random permutation of range(n) from ``gen``, made on its device
    with no sync: a stable sort of random 62-bit keys."""
    keys = torch.randint(2**62, (n,), generator=gen, device=gen.device)
    return torch.sort(keys, stable=True).indices


def _mf_updates(pu, qi, r, m, lr, reg, mu, u_gate, v_gate):
    """(U's update rows, V's update rows, the errors) of a minibatch, or of
    a data slice of one, from its fetched rows."""
    pred = (pu * qi).sum(1)
    if mu is not None:
        pred = pred + mu
    err = (r - pred) * m
    e, mm = err[:, None], m[:, None]
    return lr * ((e * qi - reg * pu * mm) * u_gate), lr * ((e * pu - reg * qi * mm) * v_gate), err


def _mf_step(U, V, u, i, r, m, lr, reg, mu, u_gate, v_gate):
    """One SGD minibatch on the extended tables, in place; returns its
    summed squared error (a device scalar)."""
    d_u, d_v, err = _mf_updates(U[u], V[i], r, m, lr, reg, mu, u_gate, v_gate)
    accumulate_rows(U, u, d_u)
    accumulate_rows(V, i, d_v)
    return (err * err).sum()


def _mf_step_sharded(mesh, U, V, u, i, r, m, lr, reg, mu, u_gate, v_gate):
    """``_mf_step`` on a mesh: U and V are this rank's row shards, the
    other arguments the whole minibatch's (module docstring)."""
    B = u.shape[0]
    lo, hi, per = batch_slice(mesh, B)
    d_u, d_v, err = _mf_updates(row_shard_lookup(mesh, U, u[lo:hi]),
                                row_shard_lookup(mesh, V, i[lo:hi]), r[lo:hi], m[lo:hi], lr,
                                reg, mu, u_gate, v_gate)
    k = d_u.shape[1]
    rows = gather_batch(mesh, torch.cat([d_u, d_v, err[:, None]], 1), B, per)
    row_shard_scatter_add(mesh, U, u, rows[:, :k].contiguous())
    row_shard_scatter_add(mesh, V, i, rows[:, k:2 * k].contiguous())
    err = rows[:, 2 * k].contiguous()
    return (err * err).sum()


def _mf_epoch(U, V, perm, mask, pairs, val, lr, reg, mu, batch_size, u_gate, v_gate,
              step=_mf_step):
    """One SGD epoch over the ratings in the order ``perm`` ((n_total,)
    int64, |R| padded to whole minibatches; ``mask`` (n_total,) float32 is
    0 on the padding), updating the extended tables in place. ``mu`` is the
    global mean when the biases are on, else None. ``step``: ``_mf_step``,
    or ``_mf_step_sharded`` bound to a mesh. Returns half the summed
    squared error (a device scalar)."""
    loss = torch.zeros((), dtype=torch.float32, device=U.device)
    for s in range(0, perm.shape[0], batch_size):
        idx, m = perm[s:s + batch_size], mask[s:s + batch_size]
        u, i = pairs[idx].unbind(1)
        loss += step(U, V, u, i, val[idx], m, lr, reg, mu, u_gate, v_gate)
    return 0.5 * loss


def _mf_optax_rows_loss(pu_raw, qi_raw, bu, bi, r, m, reg, mu, keep_u=None, keep_i=None):
    """``_mf_optax_loss`` on rows already gathered: ``bu`` and ``bi`` are
    None without the biases."""
    pu = pu_raw if keep_u is None else pu_raw * keep_u
    qi = qi_raw if keep_i is None else qi_raw * keep_i
    pred = (pu * qi).sum(1)
    if bu is not None:
        pred = pred + mu + bu + bi
    err = (r - pred) * m
    mm = m[:, None]
    reg_term = reg * ((pu_raw * pu_raw * mm).sum() + (qi_raw * qi_raw * mm).sum())
    return 0.5 * (err * err).sum() + 0.5 * reg_term


def _mf_optax_loss(params, u, i, r, m, reg, mu, use_bias, keep_u=None, keep_i=None):
    """Half the squared error plus half the L2 term of one minibatch, as
    ``cornac_tpu/models/mf.py::_mf_optax_epochs``'s ``loss_fn``: ``keep_u``
    and ``keep_i`` are the dropout masks already divided by the keep rate
    (None without dropout); the L2 term reads the rows before dropout."""
    pu_raw, qi_raw = gather_rows(params["U"], u), gather_rows(params["V"], i)
    bu = bi = None
    if use_bias:
        bu, bi = gather_rows(params["Bu"], u), gather_rows(params["Bi"], i)
    return _mf_optax_rows_loss(pu_raw, qi_raw, bu, bi, r, m, reg, mu, keep_u, keep_i)


def _mf_optax_grads(params, u, i, r, m, reg, mu, use_bias, keep_u, keep_i):
    """(the minibatch's loss, its gradients {"U", "V", "Bu", "Bi"})."""
    names = ("U", "V", "Bu", "Bi")
    loss = _mf_optax_loss(params, u, i, r, m, reg, mu, use_bias, keep_u, keep_i)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return loss, {n: torch.zeros_like(params[n]) if g is None else g
                  for n, g in zip(names, grads)}


def _mf_optax_grads_sharded(mesh, params, u, i, r, m, reg, mu, use_bias, keep_u, keep_i):
    """``_mf_optax_grads`` on a mesh, the parameters replicated: this rank
    takes the gradient of its data slice with respect to the gathered rows,
    and the per-row gradients, all-gathered in batch order, are summed into
    each table's gradient as ``gather_rows``'s backward sums them."""
    B = u.shape[0]
    lo, hi, per = batch_slice(mesh, B)
    us, its = u[lo:hi], i[lo:hi]
    rows = [params["U"][us], params["V"][its]]
    if use_bias:
        rows += [params["Bu"][us], params["Bi"][its]]
    rows = [t.detach().requires_grad_() for t in rows]
    bu, bi = rows[2:] if use_bias else (None, None)
    keep = [None if t is None else t[lo:hi] for t in (keep_u, keep_i)]
    loss = _mf_optax_rows_loss(rows[0], rows[1], bu, bi, r[lo:hi], m[lo:hi], reg, mu, *keep)
    row_grads = torch.autograd.grad(loss, rows)
    k = row_grads[0].shape[1]
    flat = torch.cat([g.reshape(g.shape[0], -1) for g in row_grads], 1)
    flat = gather_batch(mesh, flat, B, per)
    grads = {"U": accumulate_rows(torch.zeros_like(params["U"]), u, flat[:, :k].contiguous()),
             "V": accumulate_rows(torch.zeros_like(params["V"]), i,
                                  flat[:, k:2 * k].contiguous())}
    for col, (name, ids) in enumerate((("Bu", u), ("Bi", i))):
        grads[name] = torch.zeros_like(params[name])
        if use_bias:
            accumulate_rows(grads[name], ids, flat[:, 2 * k + col].contiguous())
    with torch.no_grad():
        loss = _mf_optax_loss(params, u, i, r, m, reg, mu, use_bias, keep_u, keep_i)
    return loss, grads


def _mf_optax_epoch(params, opt, opt_state, perm, mask, pairs, val, reg, mu, batch_size,
                    use_bias, dropout, gen, grads_fn=_mf_optax_grads):
    """One epoch of the general-optimizer path over the ratings in the order
    ``perm`` (padded to whole minibatches; ``mask`` 0 on the padding).
    ``params``: {"U", "V", "Bu", "Bi"} float32 tensors that require grad,
    updated in place by ``opt`` (``ops.optim``). With ``dropout`` > 0 each
    minibatch draws its user and item masks from ``gen``. Returns (the new
    optimizer state, the epoch's summed loss as a device scalar).
    ``grads_fn``: ``_mf_optax_grads``, or ``_mf_optax_grads_sharded`` bound
    to a mesh."""
    keep = 1.0 - dropout
    loss_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for s in range(0, perm.shape[0], batch_size):
        idx, m = perm[s:s + batch_size], mask[s:s + batch_size]
        u, i = pairs[idx].unbind(1)
        keep_u = keep_i = None
        if dropout > 0.0:
            shape = (idx.shape[0], params["U"].shape[1])
            keep_u = (torch.rand(shape, generator=gen, device=gen.device) < keep) / keep
            keep_i = (torch.rand(shape, generator=gen, device=gen.device) < keep) / keep
        loss, grads = grads_fn(params, u, i, val[idx], m, reg, mu, use_bias, keep_u, keep_i)
        updates, opt_state = opt.update(grads, opt_state)
        apply_updates(params, updates)
        loss_sum += loss.detach()
    return opt_state, loss_sum


def _mf_scores(U, V, Bu, Bi, mu, users, known):
    """(B, num_items) scores mu + Bu + Bi + U Vᵀ; unknown users (``known``
    0) get no personal term, as in the JAX package."""
    pu = U[users] * known[:, None]
    bu = Bu[users] * known
    with full_f32():
        return mu + bu[:, None] + Bi[None, :] + pu @ V.T


class MF(Recommender, ANNMixin):
    """Biased MF trained with deterministic minibatch SGD on the device.

    Parameters mirror the JAX package: ``k`` factors, ``max_iter`` epochs,
    ``learning_rate``, ``lambda_reg``, ``use_bias``, ``early_stop`` (stop on
    a small change of the loss), ``init_params`` ({'U','V','Bu','Bi'}),
    ``seed``, ``batch_size``. ``device``: where the model trains and scores
    (default: the card). ``optimizer``: ``"sgd"``, ``"adam"``,
    ``"rmsprop"`` or ``"adagrad"`` (optax's rules and defaults); with
    ``dropout`` > 0 the factors of each minibatch are dropped out at that
    rate. ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``
    and the factors equal the single-device fit's (module docstring).
    """

    def __init__(
        self,
        name="MF",
        k=10,
        backend="cpu",
        optimizer="sgd",
        max_iter=20,
        learning_rate=0.01,
        batch_size=256,
        lambda_reg=0.02,
        dropout=0.0,
        use_bias=True,
        early_stop=False,
        num_threads=0,
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
        self.k = k
        # the JAX package's backend selector: every value runs the same
        # path, unknown ones still raise
        if backend not in ("cpu", "pytorch", "tpu"):
            raise ValueError(f"{backend} is not supported")
        self.backend = backend
        self.optimizer = optimizer
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.lambda_reg = lambda_reg
        self.dropout = dropout
        self.use_bias = use_bias
        self.early_stop = early_stop
        self.num_threads = num_threads
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.u_factors = self.init_params.get("U", None)
        self.i_factors = self.init_params.get("V", None)
        self.u_biases = self.init_params.get("Bu", None)
        self.i_biases = self.init_params.get("Bi", None)

    def _init(self):
        rng = get_rng(self.seed)
        if self.u_factors is None:
            self.u_factors = normal(
                [self.num_users, self.k], std=0.01, random_state=rng, dtype=DTYPE
            )
        if self.i_factors is None:
            self.i_factors = normal(
                [self.num_items, self.k], std=0.01, random_state=rng, dtype=DTYPE
            )
        if self.u_biases is None:
            self.u_biases = zeros(self.num_users, dtype=DTYPE)
        if self.i_biases is None:
            self.i_biases = zeros(self.num_items, dtype=DTYPE)
        self.global_mean = np.dtype(DTYPE).type(
            self.global_mean if self.use_bias else 0.0
        )

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if self.trainable:
            self._fit(train_set)
        return self

    def _fit(self, train_set):
        opt = make_optimizer(self.optimizer, self.learning_rate)  # raises on an unknown name
        mesh = self.mesh
        dev = self._device()
        rng = get_rng(self.seed)
        rid, cid, val = train_set.uir_tuple
        n = len(val)
        bsz = min(self.batch_size, n)
        n_pad = (-n) % bsz
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        val_d = torch.as_tensor(np.asarray(val, np.float32), device=dev)
        mask = torch.cat([torch.ones(n, device=dev), torch.zeros(n_pad, device=dev)])
        pad = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        seed = rng.randint(2**31)
        last = {"loss": None}
        max_chunk = 1 if self.early_stop else None

        def permutation(epoch):
            gen = epoch_generator(seed, epoch, dev)
            return gen, torch.cat([_epoch_permutation(n, gen), pad])

        if self.optimizer != "sgd" or self.dropout > 0.0:
            params = {name: torch.tensor(np.asarray(a, np.float32), device=dev,
                                         requires_grad=True)
                      for name, a in (("U", self.u_factors), ("V", self.i_factors),
                                      ("Bu", self.u_biases), ("Bi", self.i_biases))}

            grads_fn = (_mf_optax_grads if mesh is None
                        else functools.partial(_mf_optax_grads_sharded, mesh))

            def run_optax(opt_state, start, e):
                for epoch in range(start, start + e):
                    gen, perm = permutation(epoch)
                    opt_state, loss = _mf_optax_epoch(
                        params, opt, opt_state, perm, mask, pairs, val_d, self.lambda_reg,
                        float(self.global_mean), bsz, self.use_bias, float(self.dropout), gen,
                        grads_fn)
                return opt_state, self._epoch_info(loss, last)

            epoch_loop(self, self.max_iter, run_optax, opt.init(params),
                       on_report=self._report, max_chunk=max_chunk, resident=params)
            for attr, name in (("u_factors", "U"), ("i_factors", "V"), ("u_biases", "Bu"),
                               ("i_biases", "Bi")):
                setattr(self, attr, params[name].detach().cpu().numpy())
            return

        U, V, u_gate, v_gate = _extended_tables(
            self.u_factors, self.i_factors, self.u_biases, self.i_biases, self.use_bias, dev)
        mu = float(self.global_mean) if self.use_bias else None
        n_u, n_i = U.shape[0], V.shape[0]
        step = _mf_step
        if mesh is not None:
            U, V = shard_tables(mesh, U, V)  # DTensors: what a checkpoint gathers
            step = functools.partial(_mf_step_sharded, mesh)

        def run_chunk(state, start, e):
            U, V = (local_shard(t) for t in state)
            for epoch in range(start, start + e):
                loss = _mf_epoch(U, V, permutation(epoch)[1], mask, pairs, val_d,
                                 self.learning_rate, self.lambda_reg, mu, bsz, u_gate, v_gate,
                                 step)
            return state, self._epoch_info(loss, last)

        epoch_loop(self, self.max_iter, run_chunk, (U, V), on_report=self._report,
                   max_chunk=max_chunk)
        if mesh is not None:
            U, V = U.full_tensor()[:n_u], V.full_tensor()[:n_i]

        k = self.k
        self.u_factors = U[:, :k].cpu().numpy()
        self.i_factors = V[:, :k].cpu().numpy()
        if self.use_bias:
            self.u_biases = U[:, k].cpu().numpy()
            self.i_biases = V[:, k + 1].cpu().numpy()

    def _epoch_info(self, loss, last):
        """Early-stop bookkeeping: compare this chunk's loss with the
        previous one on the host (the reference's delta-loss rule)."""
        info = {"loss": loss}
        if self.early_stop:
            value = float(loss)
            if last["loss"] is not None and abs(value - last["loss"]) < 1e-5:
                info["stop"] = True
                info["delta"] = value - last["loss"]
            last["loss"] = value
        return info

    def _report(self, done, info):
        print("Epoch %d/%d, loss = %.2f" % (done, self.max_iter, float(info["loss"])))
        if info.get("stop"):
            print("Early stopping, delta_loss = %.4f" % info["delta"])

    # ------------------------------------------------------------------ #
    # scoring
    # ------------------------------------------------------------------ #
    def score(self, user_idx, item_idx=None):
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            known_item_scores = self.global_mean + self.i_biases.astype(np.float64)
            if self.knows_user(user_idx):
                known_item_scores = known_item_scores + self.u_biases[user_idx]
                known_item_scores = known_item_scores + self.i_factors @ self.u_factors[
                    user_idx
                ]
            return known_item_scores

        item_score = self.global_mean + self.i_biases[item_idx]
        if self.knows_user(user_idx):
            item_score += self.u_biases[user_idx]
            item_score += self.u_factors[user_idx].dot(self.i_factors[item_idx])
        return item_score

    def score_batch(self, user_indices):
        scores = self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)
        return pad_to_catalog(scores, self.total_items)

    def score_batch_device(self, user_indices):
        dev = self._device()
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        U, V, Bu, Bi = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                        for a in (self.u_factors, self.i_factors, self.u_biases, self.i_biases))
        return _mf_scores(
            U, V, Bu, Bi, float(self.global_mean),
            torch.as_tensor(np.where(known, users, 0), dtype=torch.long, device=dev),
            torch.as_tensor(known.astype(DTYPE), device=dev),
        )

    def score_pairs(self, user_indices, item_indices):
        # as score()/rate(): an unknown item gets the global mean; an
        # unknown user mu + the item bias; a known pair the full biased dot
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known_u = (users >= 0) & (users < self.num_users)
        known_i = (items >= 0) & (items < self.num_items)
        u_safe = np.where(known_u, users, 0)
        i_safe = np.where(known_i, items, 0)
        personal = self.u_biases[u_safe] + np.sum(
            self.u_factors[u_safe] * self.i_factors[i_safe], axis=1
        )
        scores = (
            float(self.global_mean)
            + self.i_biases[i_safe]
            + np.where(known_u, personal, 0.0)
        )
        return np.where(known_i, scores, float(self.global_mean))

    # ------------------------------------------------------------------ #
    # ANN vectors
    # ------------------------------------------------------------------ #
    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        user_vectors = self.u_factors
        if self.use_bias:
            user_vectors = np.concatenate(
                (user_vectors, np.ones([user_vectors.shape[0], 1])), axis=1
            )
        return user_vectors

    def get_item_vectors(self):
        item_vectors = self.i_factors
        if self.use_bias:
            item_vectors = np.concatenate(
                (item_vectors, self.i_biases.reshape((-1, 1))), axis=1
            )
        return item_vectors


class SVD(MF):
    """SVD-style MF: MF with the biases on (a named alias, as in the JAX
    package). It takes MF's ``mesh``, which the JAX package's SVD does not
    pass on."""

    def __init__(
        self,
        name="SVD",
        k=10,
        max_iter=20,
        learning_rate=0.01,
        batch_size=256,
        lambda_reg=0.02,
        early_stop=False,
        num_threads=0,
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
            batch_size=batch_size,
            lambda_reg=lambda_reg,
            use_bias=True,
            early_stop=early_stop,
            num_threads=num_threads,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
