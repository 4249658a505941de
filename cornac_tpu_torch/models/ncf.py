"""NCF family — GMF, MLP, NeuMF (He et al., WWW 2017).

Port of ``cornac_tpu/models/ncf.py``: one forward per architecture over
``engine.nn`` layers, pointwise binary cross-entropy with ``num_neg``
negatives per positive drawn on the device every epoch, the optax
optimizers of ``ops.optim``, NeuMF from pretrained GMF and MLP towers, and
early stopping on validation NDCG@100 through ``ranking_eval``.

Every epoch draws, from a ``torch.Generator`` seeded from (the fit's seed,
the global epoch index): a permutation of the positives, ``num_neg``
uniform items per positive, and a permutation that mixes positives and
negatives. A negative that the user has observed is masked out of the loss
(``ops.membership``), not drawn again. The embedding lookups go through
``ops.accumulate.gather_rows``, so their gradients sum through
``accumulate_rows`` and a seeded fit gives the same bits on every run.
(The JAX package folds its key per host chunk, so its stream depends on
``verbose``; the port's does not.)

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank, as
the JAX package shards each minibatch over all mesh axes: the towers and
the optimizer's state are replicated, every rank draws the epoch's whole
stream, takes the loss of its slice of each minibatch over the
minibatch's valid count (``_bce_loss``). The embedding rows' gradients are
gathered back in batch order and summed as on one device
(``parallel.sharded.slice_rows``); the dense layers' gradients are summed
over every rank (``ops.optim.step``). ``reg``'s penalty of the embeddings
adds its gradient on every rank, that of the dense layers on rank 0 alone.
The sum over the ranks takes another order than the
single-device backward, so the fit agrees with it to float32 rounding, and
bit for bit on a mesh of one rank.
"""

import functools

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS, Dense, Tree, init_dense, init_mlp
from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.membership import build_membership
from ..ops.optim import make_optimizer, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import all_sum, batch_slice, slice_rows
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import normal, xavier_uniform
from .recommender import Recommender, pad_to_catalog

EPS = 1e-7


def _bce_loss(forward, params, u, i, y, m, reg, m_all=None, penalised=None, counted=True):
    """Masked mean binary cross-entropy of ``forward``'s probabilities,
    clipped to [EPS, 1 - EPS], plus ``reg`` times the sum of squares of the
    tensors ``penalised`` (default: every parameter of ``params``). On a
    mesh (u, i, y, m) are a rank's slice of the minibatch, ``m_all`` the
    whole minibatch's mask, which counts the mean, and ``penalised`` the
    rank's share of the penalty; with ``counted`` False the penalty adds its
    gradient and not its value (``NCFBase.fit``)."""
    p = torch.clamp(forward(params, u, i), EPS, 1.0 - EPS)
    bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    loss = torch.sum(bce * m) / torch.clamp_min(torch.sum(m if m_all is None else m_all), 1.0)
    if reg > 0:
        penalty = reg * sum(torch.sum(x**2) for x in (
            params.parameters() if penalised is None else penalised))
        loss = loss + (penalty if counted else penalty - penalty.detach())
    return loss


def _epoch_batches(gen, rid, cid, membership, num_items, num_neg, n_pad):
    """One epoch's (users, items, labels, valid) on the device, in the
    order the minibatches take them: the positives permuted, then
    ``num_neg`` uniform negatives each (valid where the user has not
    observed them), ``n_pad`` padding entries (invalid), all mixed by a
    second permutation."""
    n = rid.shape[0]
    dev = rid.device
    perm = torch.randperm(n, generator=gen, device=dev)
    pos_u, pos_i = rid[perm], cid[perm]
    neg_u = pos_u.repeat(num_neg)
    neg_i = torch.randint(num_items, (n * num_neg,), generator=gen, device=dev)
    pad = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    users = torch.cat([pos_u, neg_u, pad])
    items = torch.cat([pos_i, neg_i, pad])
    labels = torch.cat([torch.ones(n, device=dev), torch.zeros(n * num_neg + n_pad, device=dev)])
    valid = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                       ~membership.query(neg_u, neg_i),
                       torch.zeros(n_pad, dtype=torch.bool, device=dev)])
    mix = torch.randperm(users.shape[0], generator=gen, device=dev)
    return users[mix], items[mix], labels[mix], valid[mix].to(torch.float32)


class NCFBase(Recommender):
    """Shared trainer for the NCF family."""

    def __init__(
        self,
        name="NCF",
        num_epochs=20,
        batch_size=256,
        num_neg=4,
        lr=0.001,
        learner="adam",
        reg=0.0,
        backend="tensorflow",
        early_stopping=None,
        trainable=True,
        verbose=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.num_epochs = num_epochs
        self.batch_size = batch_size
        self.num_neg = num_neg
        self.lr = lr
        self.learner = learner
        self.reg = reg
        # the reference's backend selector; every value runs the same path
        # but unknown ones still error
        if backend not in ("tensorflow", "pytorch", "tpu"):
            raise ValueError(f"{backend} is not supported")
        self.backend = backend
        self.early_stopping = early_stopping
        self.seed = seed
        self.device = device

    # subclasses provide these two
    def _init_params(self, rng):
        raise NotImplementedError

    def _forward(self, params, users, items, rows=gather_rows):
        """Sigmoid probability for (user, item) int64 index batches;
        ``rows(table, ids)`` gathers the embedding rows."""
        raise NotImplementedError

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        mesh = self.mesh
        dev = self._device()
        if not hasattr(self, "params"):
            self.params = self._init_params(rng)
        self.params.to(dev)
        params = dict(self.params.named_parameters())

        rid, cid, _ = train_set.uir_tuple
        rid_d = torch.as_tensor(np.asarray(rid, np.int64), device=dev)
        cid_d = torch.as_tensor(np.asarray(cid, np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        opt = make_optimizer(self.learner, self.lr)

        n_total = len(rid) * (1 + self.num_neg)
        bsz = min(self.batch_size, n_total)
        n_pad = (-n_total) % bsz
        n_batches = (n_total + n_pad) // bsz
        seed = rng.randint(2**31)
        lo, hi, forward, whole, penalised, counted = 0, bsz, self._forward, (), None, True
        if mesh is not None:  # this rank's slice of every minibatch, over every rank
            lo, hi, _ = batch_slice(mesh, bsz, None)
            forward = functools.partial(self._forward, rows=functools.partial(
                slice_rows, mesh, axis=None))
            # the embeddings' gradients are not summed over the ranks, so
            # every rank adds the gradient of their penalty; rank 0 adds the
            # whole penalty's value and the other tensors' gradients, which
            # are summed
            whole = [name for name in params if name.endswith("_emb")]
            if mesh.get_rank() != 0:
                penalised, counted = [params[name] for name in whole], False

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                users, items, labels, valid = _epoch_batches(
                    epoch_generator(seed, epoch, dev), rid_d, cid_d, membership,
                    train_set.num_items, self.num_neg, n_pad)
                loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
                for s in range(0, n_batches * bsz, bsz):
                    sl = slice(s, s + bsz)
                    mine = slice(s + lo, s + hi)
                    # the forward takes the whole minibatch's ids; on a mesh it
                    # gathers this rank's rows (slice_rows)
                    loss = _bce_loss(forward, self.params, users[sl], items[sl], labels[mine],
                                     valid[mine], self.reg,
                                     None if mesh is None else valid[sl], penalised,
                                     counted)
                    opt_state = step(params, opt, opt_state, loss, mesh, None, whole)
                    loss_sum += loss.detach()
                if mesh is not None:  # the slices' shares make the minibatches' losses
                    all_sum(mesh, loss_sum, None)
            stop = self.early_stopping is not None and self.early_stop(
                train_set, val_set, **self.early_stopping)
            return opt_state, {"loss": loss_sum, "stop": stop}

        def report(done, info):
            print("Epoch %d/%d, loss: %.4f"
                  % (done, self.num_epochs, float(info["loss"]) / n_batches))

        epoch_loop(self, self.num_epochs, run_chunk, opt.init(params), on_report=report,
                   resident=params,
                   max_chunk=1 if self.early_stopping else None)
        return self

    def monitor_value(self, train_set, val_set):
        """Validation NDCG@100 (reference ``recom_ncf_base.py:355-385``)."""
        if val_set is None:
            return None
        from ..eval_methods import ranking_eval
        from ..metrics import NDCG

        return ranking_eval(model=self, metrics=[NDCG(k=100)], train_set=train_set,
                            test_set=val_set)[0][0]

    @torch.no_grad()
    def _forward_device(self, users, items):
        dev = self._device()
        return self._forward(self.params, torch.as_tensor(users, dtype=torch.int64, device=dev),
                             torch.as_tensor(items, dtype=torch.int64, device=dev))

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            return self._forward_device(np.full(self.num_items, user_idx),
                                        np.arange(self.num_items)).cpu().numpy()
        return float(self._forward_device([user_idx], [item_idx])[0])

    def score_pairs(self, user_indices, item_indices):
        # the NCF forward is already pairwise: one batch
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        out = self._forward_device(np.where(known, users, 0), np.where(known, items, 0))
        return np.where(known, out.cpu().numpy().astype(np.float64), self.default_score())

    def _known_scores_device(self, safe_users, known):
        u = np.repeat(np.asarray(safe_users), self.num_items)
        i = np.tile(np.arange(self.num_items), len(safe_users))
        return self._forward_device(u, i).reshape(len(safe_users), self.num_items)

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._known_scores_device(np.where(known, users, 0), known)
        scores = scores.cpu().numpy().astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)


def _embeddings(rng, num_users, num_items, dim):
    """(user, item) tables, N(0, 0.01^2) draws in that order."""
    return (normal((num_users, dim), std=1e-2, random_state=rng),
            normal((num_items, dim), std=1e-2, random_state=rng))


def _logit(rng, fan_in):
    """The output layer of GMF and MLP: w N(0, 0.01^2), b zero."""
    return Dense(normal((fan_in, 1), std=1e-2, random_state=rng),
                           np.zeros((1,), np.float32))


def _gmf_tree(rng, num_users, num_items, num_factors):
    user_emb, item_emb = _embeddings(rng, num_users, num_items, num_factors)
    return Tree(user_emb=user_emb, item_emb=item_emb, logit=_logit(rng, num_factors))


def _mlp_tree(rng, num_users, num_items, layers):
    stack = init_mlp(rng, layers)
    # xavier init for hidden weights (reference backend_pt.py:92-95)
    for i, layer in enumerate(stack):
        layer.w.data = torch.as_tensor(xavier_uniform((layers[i], layers[i + 1]), rng))
    user_emb, item_emb = _embeddings(rng, num_users, num_items, layers[0] // 2)
    return Tree(user_emb=user_emb, item_emb=item_emb, mlp=stack,
                logit=_logit(rng, layers[-1]))


def _mlp_tower(params, users, items, act, rows=gather_rows):
    h = torch.cat([rows(params.user_emb, users), rows(params.item_emb, items)], dim=-1)
    for layer in params.mlp:
        h = act(layer(h))
    return h


class GMF(NCFBase):
    """Generalized MF: sigmoid(w . (u_e * i_e))."""

    def __init__(
        self,
        name="GMF",
        num_factors=8,
        reg=0.0,
        num_epochs=20,
        batch_size=256,
        num_neg=4,
        lr=0.001,
        learner="adam",
        backend="tensorflow",
        early_stopping=None,
        trainable=True,
        verbose=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, num_epochs=num_epochs, batch_size=batch_size,
                         num_neg=num_neg, lr=lr, learner=learner, reg=reg, backend=backend,
                         early_stopping=early_stopping, trainable=trainable, verbose=verbose,
                         seed=seed, mesh=mesh, device=device)
        self.num_factors = num_factors

    def _init_params(self, rng):
        return _gmf_tree(rng, self.num_users, self.num_items, self.num_factors)

    def _forward(self, params, users, items, rows=gather_rows):
        h = rows(params.user_emb, users) * rows(params.item_emb, items)
        return torch.sigmoid(params.logit(h)).reshape(-1)


class MLP(NCFBase):
    """MLP over concatenated user/item embeddings."""

    def __init__(
        self,
        name="MLP",
        layers=(64, 32, 16, 8),
        act_fn="relu",
        reg=0.0,
        num_epochs=20,
        batch_size=256,
        num_neg=4,
        lr=0.001,
        learner="adam",
        backend="tensorflow",
        early_stopping=None,
        trainable=True,
        verbose=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, num_epochs=num_epochs, batch_size=batch_size,
                         num_neg=num_neg, lr=lr, learner=learner, reg=reg, backend=backend,
                         early_stopping=early_stopping, trainable=trainable, verbose=verbose,
                         seed=seed, mesh=mesh, device=device)
        self.layers = list(layers)
        self.act_fn = act_fn

    def _init_params(self, rng):
        return _mlp_tree(rng, self.num_users, self.num_items, self.layers)

    def _forward(self, params, users, items, rows=gather_rows):
        h = _mlp_tower(params, users, items, ACTIVATIONS[self.act_fn], rows)
        return torch.sigmoid(params.logit(h)).reshape(-1)


class NeuMF(NCFBase):
    """Fusion of GMF and MLP towers, optionally from pretrained parts."""

    def __init__(
        self,
        name="NeuMF",
        num_factors=8,
        layers=(64, 32, 16, 8),
        act_fn="relu",
        reg=0.0,
        num_epochs=20,
        batch_size=256,
        num_neg=4,
        lr=0.001,
        learner="adam",
        backend="tensorflow",
        early_stopping=None,
        trainable=True,
        verbose=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, num_epochs=num_epochs, batch_size=batch_size,
                         num_neg=num_neg, lr=lr, learner=learner, reg=reg, backend=backend,
                         early_stopping=early_stopping, trainable=trainable, verbose=verbose,
                         seed=seed, mesh=mesh, device=device)
        layers = [64, 32, 16, 8] if layers is None else list(layers)
        num_factors = layers[-1] if num_factors is None else num_factors
        if layers[-1] != num_factors:
            raise ValueError(f"the last layer ({layers[-1]}) must equal num_factors "
                             f"({num_factors})")
        self.num_factors = num_factors
        self.layers = layers
        self.act_fn = act_fn
        self.pretrained = False

    def pretrain(self, gmf_model, mlp_model, alpha=0.5):
        """Use pretrained GMF + MLP towers (reference
        ``backend_pt.py:151-165``); call before fit()."""
        self.pretrained = True
        self.pretrained_gmf = gmf_model
        self.pretrained_mlp = mlp_model
        self.alpha = alpha
        return self

    def _init_params(self, rng):
        # the towers' draws as GMF and MLP make them (their output layers
        # drawn and dropped), then the fused output layer
        gmf = _gmf_tree(rng, self.num_users, self.num_items, self.num_factors)
        mlp = _mlp_tree(rng, self.num_users, self.num_items, self.layers)
        logit = init_dense(rng, self.num_factors + self.layers[-1], 1)
        if self.pretrained:
            gmf, mlp = self.pretrained_gmf.params, self.pretrained_mlp.params
            alpha = self.alpha
            logit = Dense(
                torch.cat([alpha * gmf.logit.w, (1 - alpha) * mlp.logit.w], dim=0),
                alpha * gmf.logit.b + (1 - alpha) * mlp.logit.b)
        return Tree(
            gmf=Tree(user_emb=gmf.user_emb, item_emb=gmf.item_emb),
            mlp=Tree(user_emb=mlp.user_emb, item_emb=mlp.item_emb,
                     mlp=_copy_stack(mlp.mlp)),
            logit=logit,
        )

    def _forward(self, params, users, items, rows=gather_rows):
        h_gmf = rows(params.gmf.user_emb, users) * rows(params.gmf.item_emb, items)
        h = _mlp_tower(params.mlp, users, items, ACTIVATIONS[self.act_fn], rows)
        return torch.sigmoid(params.logit(torch.cat([h_gmf, h], dim=-1))).reshape(-1)


def _copy_stack(stack):
    """A copy of a stack of layers (so that a pretrained tower's model keeps
    its own)."""
    return torch.nn.ModuleList(Dense(layer.w, layer.b) for layer in stack)
