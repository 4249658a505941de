"""LightGCN (He et al., SIGIR 2020) and NGCF (Wang et al., SIGIR 2019).

Port of ``cornac_tpu/models/lightgcn.py``: the bipartite propagation runs in
every training step through :class:`..ops.graph.NormAdjacency` (two dense
products for small graphs, edge gathers and ``accumulate_rows`` sums beyond
the dense budget), the BPR loss over sampled triplets, Adam (optax's rule,
``ops.optim.adam``), and early stopping on validation Recall@20.

Every epoch draws, from a ``torch.Generator`` seeded from (the fit's seed,
the global epoch index), the positive pairs' indices and then the negative
items, uniformly with replacement, |R| rounded up to whole minibatches.
The rows of the propagated and the ego tables are gathered with
``gather_rows``, so their gradients sum through ``accumulate_rows`` and a
seeded fit gives the same bits on every run.

``mesh`` (``parallel.make_mesh``) shards the adjacency over every rank
(``NormAdjacency(mesh=)``: each rank propagates its part, the partial
messages are summed) and trains the towers data-parallel, as the JAX
package does: the embeddings (and NGCF's weights) and Adam's state are
replicated, every rank draws the epoch's whole stream and takes the loss of
its slice of each minibatch (over every rank) over the minibatch's size,
and the gradients are summed over every rank before the same update on
each. The sums take another order than the single-device fit's: the fit
agrees with it to float32 rounding, and bit for bit on a mesh of one rank.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.nn import Tree
from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot
from ..ops.graph import NormAdjacency
from ..ops.optim import adam, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import all_sum, batch_slice
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import xavier_uniform
from .recommender import Recommender, pad_to_catalog
from .vaecf import batch_mean


def _bpr_core(ue, ie, u, i, j, denom=None):
    """The propagated rows of the triplets and the mean softplus BPR loss
    (over ``denom`` rows when the triplets are a rank's slice of a
    minibatch of that many, ``vaecf.batch_mean``)."""
    pu, vi, vj = gather_rows(ue, u), gather_rows(ie, i), gather_rows(ie, j)
    return pu, vi, vj, batch_mean(F.softplus(torch.sum(pu * (vj - vi), dim=1)), denom)


def lightgcn_loss(params, adj, num_layers, u, i, j, lambda_reg, denom=None):
    """The JAX package's LightGCN ``loss_fn``: BPR on the propagated
    embeddings plus L2 on the batch's ego embeddings. ``denom``: the
    minibatch's size when (u, i, j) are a rank's slice of it."""
    ue, ie = adj.lightgcn(params.user_emb, params.item_emb, num_layers)
    _, _, _, bpr = _bpr_core(ue, ie, u, i, j, denom)
    reg = 0.5 * (torch.sum(gather_rows(params.user_emb, u) ** 2)
                 + torch.sum(gather_rows(params.item_emb, i) ** 2)
                 + torch.sum(gather_rows(params.item_emb, j) ** 2)) / (denom or u.shape[0])
    return bpr + lambda_reg * reg


def ngcf_embeddings(params, adj):
    """NGCF's layers: W1 (e + agg) + W2 (e * agg), LeakyReLU(0.2), each
    layer's output L2-normalized; all layers concatenated."""
    ue, ie = params.user_emb, params.item_emb
    ue_out, ie_out = [ue], [ie]
    for W1, W2 in zip(params.W1, params.W2):
        agg_u, agg_i = adj.propagate(ue, ie)
        new_u = F.leaky_relu((ue + agg_u) @ W1 + (ue * agg_u) @ W2, negative_slope=0.2)
        new_i = F.leaky_relu((ie + agg_i) @ W1 + (ie * agg_i) @ W2, negative_slope=0.2)
        ue = new_u / torch.clamp_min(torch.linalg.vector_norm(new_u, dim=1, keepdim=True), 1e-12)
        ie = new_i / torch.clamp_min(torch.linalg.vector_norm(new_i, dim=1, keepdim=True), 1e-12)
        ue_out.append(ue)
        ie_out.append(ie)
    return torch.cat(ue_out, dim=1), torch.cat(ie_out, dim=1)


def ngcf_loss(params, adj, u, i, j, lambda_reg, denom=None):
    """The JAX package's NGCF ``loss_fn``: BPR plus L2 on the batch's
    propagated rows. ``denom``: as ``lightgcn_loss``'s."""
    ue, ie = ngcf_embeddings(params, adj)
    pu, vi, vj, bpr = _bpr_core(ue, ie, u, i, j, denom)
    reg = 0.5 * (torch.sum(pu**2) + torch.sum(vi**2) + torch.sum(vj**2)) / (denom or u.shape[0])
    return bpr + lambda_reg * reg


class LightGCN(Recommender):
    """Linear graph-convolutional CF: mean of K propagation layers, BPR."""

    def __init__(
        self,
        name="LightGCN",
        emb_size=64,
        num_epochs=1000,
        learning_rate=0.001,
        batch_size=1024,
        num_layers=3,
        early_stopping=None,
        lambda_reg=1e-4,
        trainable=True,
        verbose=False,
        seed=2020,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.emb_size = emb_size
        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.num_layers = num_layers
        self.early_stopping = early_stopping
        self.lambda_reg = lambda_reg
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

    def _init_params(self, rng):
        return Tree(user_emb=xavier_uniform((self.total_users, self.emb_size), rng),
                    item_emb=xavier_uniform((self.total_items, self.emb_size), rng))

    def _loss(self, params, u, i, j, denom=None):
        return lightgcn_loss(params, self._adj, self.num_layers, u, i, j, self.lambda_reg, denom)

    @torch.no_grad()
    def _propagated(self, params):
        return self._adj.lightgcn(params.user_emb, params.item_emb, self.num_layers)

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
        self._adj = NormAdjacency(train_set, mesh=mesh, device=dev)

        rid, cid, _ = train_set.uir_tuple
        rid_d = torch.as_tensor(np.asarray(rid, np.int64), device=dev)
        cid_d = torch.as_tensor(np.asarray(cid, np.int64), device=dev)
        n = len(rid)
        bsz = min(self.batch_size, n)
        n_batches = (n + bsz - 1) // bsz
        num_items = train_set.num_items
        opt = adam(self.learning_rate)
        seed = rng.randint(2**31)
        lo, hi, denom = 0, bsz, None
        if mesh is not None:  # this rank's slice of every minibatch, over every rank
            lo, hi, _ = batch_slice(mesh, bsz, None)
            denom = bsz

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                gen = epoch_generator(seed, epoch, dev)
                pos_idx = torch.randint(n, (n_batches * bsz,), generator=gen, device=dev)
                negs = torch.randint(num_items, (n_batches * bsz,), generator=gen, device=dev)
                loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
                for s in range(0, n_batches * bsz, bsz):
                    idx = pos_idx[s + lo:s + hi]
                    loss = self._loss(self.params, rid_d[idx], cid_d[idx], negs[s + lo:s + hi],
                                      denom)
                    opt_state = step(params, opt, opt_state, loss, mesh, None)
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
        self._cache_embeddings()
        return self

    def _cache_embeddings(self):
        """The propagated tables, for scoring."""
        ue, ie = self._propagated(self.params)
        self.U = ue.cpu().numpy()
        self.V = ie.cpu().numpy()

    def monitor_value(self, train_set, val_set):
        """Validation Recall@20 (reference recom_lightgcn.py:196-227)."""
        if val_set is None:
            return None
        from ..eval_methods import ranking_eval
        from ..metrics import Recall

        self._cache_embeddings()
        return ranking_eval(model=self, metrics=[Recall(k=20)], train_set=train_set,
                            test_set=val_set)[0][0]

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self.V @ self.U[user_idx]
        return self.V[item_idx] @ self.U[user_idx]

    def _known_scores_device(self, safe_users, known):
        return device_dot(self.U[safe_users], self.V, self._device())

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self.U[np.where(known, users, 0)] @ self.V.T
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        preds = np.sum(self.U[np.where(known, users, 0)] * self.V[np.where(known, items, 0)],
                       axis=1)
        return np.where(known, preds, self.default_score())


class NGCF(LightGCN):
    """Neural Graph CF: propagation with per-layer transforms, bilinear
    interaction term, LeakyReLU, and concatenated layer outputs (reference
    ``models/ngcf/recom_ngcf.py:23``)."""

    def __init__(
        self,
        name="NGCF",
        emb_size=64,
        layer_sizes=None,
        dropout_rates=None,
        num_epochs=1000,
        learning_rate=0.001,
        batch_size=1024,
        early_stopping=None,
        lambda_reg=1e-4,
        trainable=True,
        verbose=False,
        seed=2020,
        mesh=None,
        device=None,
    ):
        layer_sizes = [64, 64, 64] if layer_sizes is None else list(layer_sizes)
        super().__init__(name=name, emb_size=emb_size, num_epochs=num_epochs,
                         learning_rate=learning_rate, batch_size=batch_size,
                         num_layers=len(layer_sizes), early_stopping=early_stopping,
                         lambda_reg=lambda_reg, trainable=trainable, verbose=verbose,
                         seed=seed, mesh=mesh, device=device)
        self.layer_sizes = layer_sizes
        self.dropout_rates = dropout_rates  # kept for API parity

    def _init_params(self, rng):
        user_emb = xavier_uniform((self.total_users, self.emb_size), rng)
        item_emb = xavier_uniform((self.total_items, self.emb_size), rng)
        sizes = [self.emb_size] + self.layer_sizes
        W1, W2 = [], []
        for k in range(len(self.layer_sizes)):
            W1.append(xavier_uniform((sizes[k], sizes[k + 1]), rng))
            W2.append(xavier_uniform((sizes[k], sizes[k + 1]), rng))
        return Tree(user_emb=user_emb, item_emb=item_emb, W1=W1, W2=W2)

    def _loss(self, params, u, i, j, denom=None):
        return ngcf_loss(params, self._adj, u, i, j, self.lambda_reg, denom)

    @torch.no_grad()
    def _propagated(self, params):
        return ngcf_embeddings(params, self._adj)
