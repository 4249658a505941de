"""GCMC — Graph Convolutional Matrix Completion (van den Berg et al., 2017).

Port of ``cornac_tpu/models/gcmc.py``: the rating graph as flat edge arrays
(user, item, rating class), one encoder layer of per-rating message passing
with identity node features (so each rating's convolution weight is an
embedding table), stack or sum across ratings, dropout, dense heads, the
basis-bilinear decoder, softmax cross-entropy over rating classes, global
norm clipping and an optimizer whose learning rate decays on a validation
plateau, early stopping on the validation RMSE, and expected-rating
prediction.

The rating-typed sums ``zeros.at[ei].add(...)`` / ``.at[eu].add(...)`` of
the JAX package lie inside the differentiated forward. Here they go through
``ops.graph.scatter_rows`` (``accumulate_rows`` forward, a gather
backward), and every row gather of a differentiated table through
``gather_rows`` (a gather forward, ``accumulate_rows`` backward): each sum
is taken in edge order, never by atomics, so a seeded fit gives the same
bits on every run. Dropout draws come from a ``torch.Generator`` keyed on
(seed, global iteration), where the JAX package folds the iteration into
its key.

``mesh`` (``parallel.make_mesh``) splits the rating edges over "data", as
the JAX package does, and replicates the parameters and the optimizer's
state. Each rank passes the messages of its slice of the edges, the
per-rating sums are summed over "data" (``all_sum_messages``), every rank
draws the whole dropout masks, and takes the cross-entropy of its edges
over the number of all edges. The gradients are summed over "data" before
the clipping and the same update on each rank. A slice need not divide the
edges, so none is padded (the JAX package pads with edges of label
``n_ratings`` and weight 0). The sums take another order than the
single-device fit's: the fit agrees with it to float32 rounding, and bit
for bit on a mesh of one rank.
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS, Tree
from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.graph import scatter_rows
from ..ops.optim import OPTIMIZERS
from ..parallel.mesh import check_mesh
from ..parallel.sharded import all_sum, all_sum_messages, batch_slice, sum_grads
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .recommender import Recommender
from .vaecf import batch_mean


def _xavier(rng, shape):
    fan_in, fan_out = shape[-2], shape[-1]
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _init_gcmc(rng, n_users, n_items, n_ratings, agg_units, out_units,
               agg_accum, share_param, num_basis):
    """The JAX package's parameters, drawn in its order. With
    ``share_param`` (and as many users as items) the item tables start as
    a copy of the user tables: the JAX pytree holds them as two leaves,
    each with its own gradient."""
    msg = agg_units // n_ratings if agg_accum == "stack" else agg_units
    Wu = _xavier(rng, (n_ratings, n_users, msg))
    Wi = _xavier(rng, (n_ratings, n_items, msg))
    params = dict(
        Wu=Wu, Wi=Wi,
        ufc_w=_xavier(rng, (agg_units, out_units)),
        ufc_b=np.zeros((out_units,), np.float32),
        P=_xavier(rng, (num_basis, out_units, out_units)),
        combine=_xavier(rng, (num_basis, n_ratings)),
    )
    if share_param and n_users == n_items:
        params["Wi"] = Wu.copy()
    else:
        params["ifc_w"] = _xavier(rng, (agg_units, out_units))
        params["ifc_b"] = np.zeros((out_units,), np.float32)
    return Tree(**params)


def _encode(params, graph, act, n_ratings, agg_accum, dropout, generator, mesh=None):
    """One GCMC layer of per-rating bipartite message passing: (user
    features, item features). ``graph``: edge_u, edge_i (int64), edge_label
    and the 1/sqrt(degree) norms ci_u, cj_u, ci_i, cj_i, on the device.
    ``mesh``: the edges are this rank's data slice of them, and each
    rating's messages are summed over "data" before their norms."""
    eu, ei, lab = graph["edge_u"], graph["edge_i"], graph["edge_label"]
    n_users, n_items = params.Wu.shape[1], params.Wi.shape[1]
    cj_u = graph["cj_u"][eu][:, None]
    cj_i = graph["cj_i"][ei][:, None]
    to_items, to_users = [], []
    for r in range(n_ratings):
        m = (lab == r).to(torch.float32)[:, None]
        # user -> item messages: rating r's rows of the source users
        to_items.append(scatter_rows(gather_rows(params.Wu[r], eu) * cj_u * m, ei, n_items))
        # item -> user (the reverse edges)
        to_users.append(scatter_rows(gather_rows(params.Wi[r], ei) * cj_i * m, eu, n_users))
    if mesh is not None:  # every rating's sums over "data", in one collective
        both = all_sum_messages(mesh, torch.cat(to_items + to_users))
        to_items = list(both[:n_ratings * n_items].split(n_items))
        to_users = list(both[n_ratings * n_items:].split(n_users))
    i_msgs = [x * graph["ci_i"][:, None] for x in to_items]
    u_msgs = [x * graph["ci_u"][:, None] for x in to_users]
    if agg_accum == "stack":
        ufeat = torch.cat(u_msgs, dim=1)
        ifeat = torch.cat(i_msgs, dim=1)
    else:  # sum, in rating order as Python's sum() adds them
        ufeat = sum(u_msgs)
        ifeat = sum(i_msgs)

    ufeat, ifeat = act(ufeat), act(ifeat)
    if generator is not None and dropout > 0.0:
        keep = 1.0 - dropout
        ufeat = ufeat * (torch.rand(ufeat.shape, generator=generator,
                                    device=ufeat.device) < keep) / keep
        ifeat = ifeat * (torch.rand(ifeat.shape, generator=generator,
                                    device=ifeat.device) < keep) / keep
    ufeat = ufeat @ params.ufc_w + params.ufc_b
    if hasattr(params, "ifc_w"):
        ifeat = ifeat @ params.ifc_w + params.ifc_b
    else:
        ifeat = ifeat @ params.ufc_w + params.ufc_b
    return ufeat, ifeat


def _decode_pairs(params, ufeat, ifeat, pu, pi):
    """Basis-bilinear logits (B, n_ratings) of the pairs (pu, pi)."""
    u = gather_rows(ufeat, pu)
    v = gather_rows(ifeat, pi)
    basis = torch.einsum("bd,kde,be->bk", u, params.P, v)
    return basis @ params.combine


def _clip_by_global_norm(grads, max_norm):
    """optax's ``clip_by_global_norm``: every gradient scaled by
    max_norm / norm when the global norm reaches max_norm, on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {name: torch.where(keep, g, (g / norm) * max_norm) for name, g in grads.items()}


class GCMC(Recommender):
    """Graph convolutional matrix completion with rating-typed edges.
    ``device``: where it trains and scores (default: the card; ``"cpu"``
    asks for the CPU). ``mesh``: a ``parallel.make_mesh`` mesh; every rank
    calls ``fit`` (module docstring)."""

    def __init__(
        self,
        name="GCMC",
        max_iter=2000,
        learning_rate=0.01,
        optimizer="adam",
        activation_func="leaky_relu",
        gcn_agg_units=500,
        gcn_out_units=75,
        gcn_dropout=0.7,
        gcn_agg_accum="stack",
        share_param=False,
        gen_r_num_basis_func=2,
        train_grad_clip=1.0,
        train_valid_interval=1,
        train_early_stopping_patience=100,
        train_min_learning_rate=0.001,
        train_decay_patience=50,
        train_lr_decay_factor=0.5,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.optimizer = optimizer
        self.activation_func = activation_func
        self.gcn_agg_units = gcn_agg_units
        self.gcn_out_units = gcn_out_units
        self.gcn_dropout = gcn_dropout
        self.gcn_agg_accum = gcn_agg_accum
        self.share_param = share_param
        self.gen_r_num_basis_func = gen_r_num_basis_func
        self.train_grad_clip = train_grad_clip
        self.train_valid_interval = train_valid_interval
        self.train_early_stopping_patience = train_early_stopping_patience
        self.train_min_learning_rate = train_min_learning_rate
        self.train_decay_patience = train_decay_patience
        self.train_lr_decay_factor = train_lr_decay_factor
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        if gcn_agg_accum not in ("stack", "sum"):
            raise ValueError("gcn_agg_accum must be 'stack' or 'sum'")

    # ---------------------------------------------------------------- graph
    def _build_graph(self, train_set, device):
        u, i, r = train_set.uir_tuple
        self.rating_values = np.unique(r)
        labels = np.searchsorted(self.rating_values, r)
        deg_u = np.bincount(u, minlength=self.num_users).astype(np.float32)
        deg_i = np.bincount(i, minlength=self.num_items).astype(np.float32)

        def inv_sqrt(d):
            return torch.as_tensor(1.0 / np.sqrt(np.where(d == 0, np.inf, d)), device=device)

        def ids(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        # symmetric norms: ci = cj = 1/sqrt(degree)
        return {"edge_u": ids(u), "edge_i": ids(i), "edge_label": ids(labels),
                "ci_u": inv_sqrt(deg_u), "cj_u": inv_sqrt(deg_u),
                "ci_i": inv_sqrt(deg_i), "cj_i": inv_sqrt(deg_i)}

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        rng = get_rng(self.seed)
        if self.activation_func not in ACTIVATIONS:
            raise ValueError("Supported act_fn: {}".format(list(ACTIVATIONS)))
        act = ACTIVATIONS[self.activation_func]
        mesh = self.mesh
        dev = self._device()

        self.graph = graph = self._build_graph(train_set, dev)
        n_ratings = len(self.rating_values)
        agg_units = self.gcn_agg_units
        if self.gcn_agg_accum == "stack":
            agg_units -= agg_units % n_ratings  # keep divisibility
            agg_units = max(agg_units, n_ratings)
        if not hasattr(self, "params"):
            self.params = _init_gcmc(rng, self.num_users, self.num_items, n_ratings, agg_units,
                                     self.gcn_out_units, self.gcn_agg_accum, self.share_param,
                                     self.gen_r_num_basis_func)
        self.params.to(dev)
        if not self.trainable:
            self._refresh_embeddings(act, n_ratings, self.gcn_agg_accum)
            return self

        opt_name = self.optimizer.lower()
        if opt_name not in OPTIMIZERS:
            raise ValueError("Unknown optimizer: {}".format(self.optimizer))
        # the rule at a unit rate, its updates scaled by the current rate:
        # the decay on a plateau swaps the rate and keeps the moments
        opt = OPTIMIZERS[opt_name](1.0)
        params = dict(self.params.named_parameters())
        opt_state = opt.init(params)
        lr = self.learning_rate
        n_edges = graph["edge_u"].shape[0]
        if mesh is not None:  # this rank's data slice of the edges
            lo, hi, _ = batch_slice(mesh, n_edges)
            graph = dict(graph, **{k: graph[k][lo:hi] for k in ("edge_u", "edge_i", "edge_label")})
        pu, pi, lab = graph["edge_u"], graph["edge_i"], graph["edge_label"]
        agg_accum, dropout = self.gcn_agg_accum, self.gcn_dropout
        values = torch.as_tensor(self.rating_values, dtype=torch.float32, device=dev)
        seed = rng.randint(2**31)

        def train_step(t, opt_state, lr):
            gen = epoch_generator(seed, t, dev) if dropout > 0.0 else None
            ufeat, ifeat = _encode(self.params, graph, act, n_ratings, agg_accum, dropout, gen,
                                   mesh)
            logits = _decode_pairs(self.params, ufeat, ifeat, pu, pi)
            ce = torch.logsumexp(logits, dim=1) - logits.gather(1, lab[:, None])[:, 0]
            loss = batch_mean(ce, None if mesh is None else n_edges)
            grads = torch.autograd.grad(loss, list(params.values()))
            if mesh is not None:  # the edge slices' shares make the gradients and the loss
                grads = sum_grads(mesh, grads)
                loss = all_sum(mesh, loss.detach().clone())
            grads = dict(zip(params, grads))
            updates, opt_state = opt.update(
                _clip_by_global_norm(grads, self.train_grad_clip), opt_state)
            with torch.no_grad():
                # the rate in float32, as optax's injected hyperparameter
                torch._foreach_add_(list(params.values()),
                                    torch._foreach_mul(list(updates.values()),
                                                       float(np.float32(lr))))
            return opt_state, loss.detach()

        @torch.no_grad()
        def valid_rmse(vu, vi, vr):
            ufeat, ifeat = _encode(self.params, graph, act, n_ratings, agg_accum, 0.0, None, mesh)
            pred = torch.softmax(_decode_pairs(self.params, ufeat, ifeat, vu, vi), dim=1) @ values
            return float(torch.sqrt(torch.mean((pred - vr) ** 2)))

        if val_set is None:
            done = 0
            chunk = self.max_iter if not self.verbose else max(1, self.max_iter // 10)
            while done < self.max_iter:
                n = min(chunk, self.max_iter - done)
                for t in range(done, done + n):
                    opt_state, loss = train_step(t, opt_state, lr)
                done += n
                if self.verbose:
                    print("Iter %d/%d, loss: %.4f" % (done, self.max_iter, loss))
        else:
            vu, vi = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                      for a in val_set.uir_tuple[:2])
            vr = torch.as_tensor(np.asarray(val_set.uir_tuple[2], np.float32), device=dev)
            best_rmse, best_params, no_improve, decay_wait = np.inf, None, 0, 0
            done = 0
            interval = max(1, self.train_valid_interval)
            while done < self.max_iter:
                n = min(interval, self.max_iter - done)
                for t in range(done, done + n):
                    opt_state, loss = train_step(t, opt_state, lr)
                done += n
                rmse = valid_rmse(vu, vi, vr)
                if rmse < best_rmse:
                    best_rmse, no_improve, decay_wait = rmse, 0, 0
                    best_params = {k: v.detach().clone() for k, v in params.items()}
                else:
                    no_improve += 1
                    decay_wait += 1
                if no_improve >= self.train_early_stopping_patience:
                    break
                if decay_wait >= self.train_decay_patience:
                    new_lr = max(lr * self.train_lr_decay_factor, self.train_min_learning_rate)
                    if new_lr < lr:
                        lr = new_lr
                    decay_wait = 0
                if self.verbose:
                    print("Iter %d/%d, loss %.4f, valid rmse %.4f"
                          % (done, self.max_iter, loss, rmse))
            if best_params is not None:
                with torch.no_grad():
                    for k, v in params.items():
                        v.copy_(best_params[k])

        # eval-mode node embeddings for scoring
        self._refresh_embeddings(act, n_ratings, agg_accum)
        return self

    @torch.no_grad()
    def _refresh_embeddings(self, act=None, n_ratings=None, agg_accum=None):
        act = act or ACTIVATIONS[self.activation_func]
        n_ratings = n_ratings or len(self.rating_values)
        agg_accum = agg_accum or self.gcn_agg_accum
        self.ufeat, self.ifeat = _encode(self.params, self.graph, act, n_ratings, agg_accum,
                                         0.0, None)

    # ------------------------------------------------------------- scoring
    @torch.no_grad()
    def _expected_ratings(self, pu, pi):
        dev = self.ufeat.device
        logits = _decode_pairs(self.params, self.ufeat, self.ifeat,
                               torch.as_tensor(np.asarray(pu, np.int64), device=dev),
                               torch.as_tensor(np.asarray(pi, np.int64), device=dev))
        values = torch.as_tensor(self.rating_values, dtype=torch.float32, device=dev)
        return (torch.softmax(logits, dim=1) @ values).cpu().numpy()

    def transform(self, test_set):
        """Precompute the expected ratings of the test pairs."""
        tu, ti, _ = test_set.uir_tuple
        preds = self._expected_ratings(tu, ti)
        self.u_i_rating_dict = {"%d-%d" % (u, i): float(p) for u, i, p in zip(tu, ti, preds)}

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is None:
            items = np.arange(self.num_items)
            return self._expected_ratings(np.full_like(items, user_idx), items)
        if self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if hasattr(self, "u_i_rating_dict"):
            got = self.u_i_rating_dict.get("%d-%d" % (user_idx, item_idx))
            if got is not None:
                return got
        return float(self._expected_ratings([user_idx], [item_idx])[0])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        items = np.arange(self.num_items)
        pu = np.repeat(safe, self.num_items)
        pi = np.tile(items, len(users))
        scores = self._expected_ratings(pu, pi).reshape(len(users), self.num_items)
        scores = scores.astype(np.float64)
        scores[~known] = self.default_score()
        total = self.total_items
        if scores.shape[1] < total:
            out = np.broadcast_to(
                scores.min(axis=1, keepdims=True), (scores.shape[0], total)
            ).copy()
            out[:, : scores.shape[1]] = scores
            return out
        return scores
