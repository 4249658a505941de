"""IBPR / OnlineIBPR (Le et al., 2017) and COE (Le & Lauw, 2016).

Port of ``cornac_tpu/models/ibpr.py``: one trainer for the three, Adam
(optax's rule, ``ops.optim.adam``) over {"U", "V"} on sampled triplets, the
loss by autograd on the model's device.

- IBPR and OnlineIBPR: pairwise logistic loss on the angular distances of
  the normalised embeddings; OnlineIBPR zeroes V's gradient, so Adam still
  decays V's moments and moves V by what they hold (none, from a zero start).
- COE: pairwise logistic loss on Euclidean distances; it scores with the
  negative distance, as the JAX package does.

Each epoch draws (positive pair, negative item) uniformly with replacement
from a ``torch.Generator`` seeded from (the fit's seed, the global epoch
index), |R| rounded up to whole minibatches, and masks out the triplets
whose negative the user has observed (``ops.membership``). The gradients of
the row gathers sum through the deterministic ``accumulate_rows``
(``ops.accumulate.gather_rows``), so a seeded fit gives the same bits on
every run. Nothing syncs with the host inside an epoch.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot, device_neg_l2
from ..ops.membership import build_membership
from ..ops.optim import adam, apply_updates
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from .bpr import _bpr_draws
from .recommender import ANNMixin, MEASURE_DOT, MEASURE_L2, Recommender, pad_to_catalog


def _angular_dist(a, b):
    an = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=1, keepdim=True), 1e-12)
    bn = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=1, keepdim=True), 1e-12)
    return torch.arccos(torch.clamp((an * bn).sum(1), -1 + 1e-7, 1 - 1e-7))


def _euclid_dist(a, b):
    return torch.linalg.vector_norm(a - b + 1e-12, dim=1)


def _triplet_loss(params, u, i, j, m, lamda, distance):
    """The JAX package's ``loss_fn``: -Σ m·log σ(d(u, j) − d(u, i)) plus
    lamda times the squared norms of the gathered rows (unmasked)."""
    pu = gather_rows(params["U"], u)
    v = gather_rows(params["V"], torch.cat([i, j]))
    vi, vj = v[: i.shape[0]], v[i.shape[0]:]
    dist = _angular_dist if distance == "angular" else _euclid_dist
    core = -(F.logsigmoid(dist(pu, vj) - dist(pu, vi)) * m).sum()
    return core + lamda * ((pu * pu).sum() + (vi * vi).sum() + (vj * vj).sum())


def _triplet_step(params, opt, opt_state, u, i, j, m, lamda, distance, update_items):
    """One Adam step on the triplets (u, i, j) with mask ``m`` (float32),
    updating ``params`` in place. Returns (the new state, the loss)."""
    loss = _triplet_loss(params, u, i, j, m, lamda, distance)
    gU, gV = torch.autograd.grad(loss, [params["U"], params["V"]])
    if not update_items:
        gV = torch.zeros_like(gV)
    updates, opt_state = opt.update({"U": gU, "V": gV}, opt_state)
    apply_updates(params, updates)
    return opt_state, loss.detach()


class _TripletEmbedBase(Recommender, ANNMixin):
    """Shared Adam-over-sampled-triplets trainer."""

    _distance = "angular"
    _update_items = True

    def __init__(
        self,
        name,
        k=20,
        max_iter=100,
        learning_rate=0.05,
        lamda=0.001,
        batch_size=100,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.k = k
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lamda = lamda
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        rng = get_rng(self.seed)
        if self.U is None:
            self.U = rng.randn(self.num_users, self.k).astype(np.float32)
        if self.V is None:
            self.V = rng.randn(self.num_items, self.k).astype(np.float32)
        if not self.trainable:
            return self

        dev = self._device()
        rid, cid, _ = train_set.uir_tuple
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        n = len(rid)
        bsz = min(self.batch_size, n)
        n_batches = (n + bsz - 1) // bsz
        params = {name: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for name, a in (("U", self.U), ("V", self.V))}
        opt = adam(self.learning_rate)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
                draws = _bpr_draws(epoch_generator(seed, epoch, dev), n, n_batches * bsz, bsz,
                                   train_set.num_items, None)
                for pos_idx, negs in draws:
                    users, pos = pairs[pos_idx].unbind(1)
                    valid = (~membership.query(users, negs)).to(torch.float32)
                    for s in range(0, pos_idx.shape[0], bsz):
                        sl = slice(s, s + bsz)
                        opt_state, loss = _triplet_step(
                            params, opt, opt_state, users[sl], pos[sl], negs[sl], valid[sl],
                            self.lamda, self._distance, self._update_items)
                        loss_sum += loss
            return opt_state, loss_sum

        epoch_loop(self, self.max_iter, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Epoch %d/%d, loss: %.4f" % (done, self.max_iter, float(loss) / n_batches)))

        self.U = params["U"].detach().cpu().numpy().astype(np.float64)
        self.V = params["V"].detach().cpu().numpy().astype(np.float64)
        return self

    def _scores_for(self, users):
        if self._distance == "angular":
            return self.U[users] @ self.V.T
        diff = self.U[users][:, None, :] - self.V[None, :, :]
        return -np.linalg.norm(diff, axis=2)

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        row = self._scores_for(np.asarray([user_idx]))[0]
        return row if item_idx is None else row[item_idx]

    def _known_scores_device(self, safe_users, known):
        dev = self._device()
        rows = np.asarray(self.U, np.float32)[safe_users]
        if self._distance == "angular":
            return device_dot(rows, self.V, dev)
        return device_neg_l2(rows, self.V, dev)

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._scores_for(np.where(known, users, 0))
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def get_vector_measure(self):
        return MEASURE_DOT if self._distance == "angular" else MEASURE_L2

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.V


class IBPR(_TripletEmbedBase):
    """Indexable BPR: angular pairwise ranking."""

    def __init__(self, name="IBPR", k=20, max_iter=100, learning_rate=0.05, lamda=0.001,
                 batch_size=100, trainable=True, verbose=False, init_params=None, seed=None,
                 mesh=None, device=None):
        super().__init__(name=name, k=k, max_iter=max_iter, learning_rate=learning_rate,
                         lamda=lamda, batch_size=batch_size, trainable=trainable,
                         verbose=verbose, init_params=init_params, seed=seed, mesh=mesh,
                         device=device)


class OnlineIBPR(_TripletEmbedBase):
    """Online IBPR: the same angular objective; only the user table moves."""

    _update_items = False

    def __init__(self, name="OnlineIBPR", k=20, max_iter=100, learning_rate=0.001,
                 lamda=0.005, batch_size=100, trainable=True, verbose=False, init_params=None,
                 seed=None, mesh=None, device=None):
        super().__init__(name=name, k=k, max_iter=max_iter, learning_rate=learning_rate,
                         lamda=lamda, batch_size=batch_size, trainable=trainable,
                         verbose=verbose, init_params=init_params, seed=seed, mesh=mesh,
                         device=device)


class COE(_TripletEmbedBase):
    """Collaborative Ordinal Embedding: Euclidean pairwise ranking."""

    _distance = "euclidean"

    def __init__(self, name="COE", k=20, max_iter=100, learning_rate=0.05, lamda=0.001,
                 batch_size=1000, trainable=True, verbose=False, init_params=None, seed=None,
                 mesh=None, device=None):
        super().__init__(name=name, k=k, max_iter=max_iter, learning_rate=learning_rate,
                         lamda=lamda, batch_size=batch_size, trainable=trainable,
                         verbose=verbose, init_params=init_params, seed=seed, mesh=mesh,
                         device=device)
