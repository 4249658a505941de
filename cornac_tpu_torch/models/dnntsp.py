"""DNNTSP — Deep Neural Network for Temporal Set Prediction (Yu et al.,
KDD 2020).

Port of ``cornac_tpu/models/dnntsp.py``: each user's item graph is a padded
dense block (node ids (B, N), per-step edge weights (B, T, N, N)); two
weighted graph convolutions with batch statistics over the valid (B, T, N)
cells, causal masked self-attention over the T steps (4 heads), a learned
temporal aggregation, and the gated update against the whole item
embedding table; the losses ``bpr`` (one sampled negative per item slot),
``mse``, ``weight_mse`` and ``multi_label_soft_margin``; the optimisers
``adam`` (``adamw`` with a weight decay), ``sgd`` and ``rmsprop``, optax's
rules (``ops.optim``). Inference normalises with the scored batch's own
statistics, as the JAX package does.

Determinism on the card: the gathers of embedding and gate rows go through
``ops.accumulate.gather_rows``, whose backward sums in batch order
(``index_put_``'s and ``embedding``'s backward use atomics there), and so
does the gather of the negatives' scores. Every epoch draws its permutation
and then each step's negatives from one generator keyed on (seed, epoch):
the JAX package's distributions, another stream.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank:
each rank draws the whole stream, runs its rows of a minibatch (their
negatives cut from the whole minibatch's draw), and the batch statistics
of the graph convolutions are the whole minibatch's, summed over the ranks
forward and backward (``Share.sum``); the loss is the rank's share of the
minibatch's, and ``ops.optim.step`` sums the gradients.
``score_baskets_batch`` splits the graph blocks over the ranks when their
padded count divides the mesh, with the statistics of the whole scored
batch, as the JAX package shards them.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.nn import Tree
from ..ops.accumulate import gather_rows
from ..ops.optim import adam, adamw, rmsprop, sgd, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, data_parallel
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .recommender import NextBasketRecommender
from .seq_utils import pad_batch_rows
from .vaecf import batch_mean

BN_EPS = 1e-5
N_HEADS = 4
LOSSES = ("bpr", "mse", "weight_mse", "multi_label_soft_margin")


def _glorot(rng, shape):
    bound = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _init_params(rng, n_items, E):
    """The JAX package's parameters as a ``Tree``, drawn from ``rng`` in its
    order."""
    return Tree(
        emb=rng.normal(0, 1.0, size=(n_items, E)).astype(np.float32),
        # two weighted graph convolutions (hidden [E] + output E)
        gcn_w=[_glorot(rng, (E, E)), _glorot(rng, (E, E))],
        gcn_b=[np.zeros((E,), np.float32), np.zeros((E,), np.float32)],
        bn_scale=[np.ones((E,), np.float32), np.ones((E,), np.float32)],
        bn_offset=[np.zeros((E,), np.float32), np.zeros((E,), np.float32)],
        Wq=_glorot(rng, (E, E)),
        Wk=_glorot(rng, (E, E)),
        Wv=_glorot(rng, (E, E)),
        Wagg=_glorot(rng, (E, 1)),
        alpha=rng.rand(n_items, 1).astype(np.float32),
        fc_w=_glorot(rng, (E, 1)),
        fc_b=np.zeros((1,), np.float32),
    )


def dnntsp_scores(params, node_ids, node_mask, W, lengths, share=None):
    """(B, items) scores of the graph blocks: node_ids (B, N) int64,
    node_mask (B, N) bool, W (B, T, N, N) float32, lengths (B,).
    ``share`` (``parallel.sharded.Share``, on a mesh): the blocks are a
    rank's rows of a batch, and the batch statistics the whole batch's,
    the ranks' partial sums summed (a collective every rank calls)."""
    B, N = node_ids.shape
    T = W.shape[1]
    E = params.emb.shape[1]
    n_items = params.emb.shape[0]
    maskf = node_mask.to(torch.float32)

    safe_ids = torch.where(node_mask, node_ids, 0)
    flat_ids = safe_ids.reshape(-1)
    h = gather_rows(params.emb, flat_ids).reshape(B, N, E) * maskf[..., None]

    # stacked weighted graph convolutions over the per-step graphs
    x = h[:, None, :, :].expand(B, T, N, E)
    # batch statistics over the valid (B, T, N) cells: a node's mask holds
    # at every step, padded steps included
    m = maskf[:, None, :, None] * torch.ones((1, T, 1, 1), device=W.device)
    whole = (lambda x: x) if share is None else share.sum
    cnt = torch.clamp(whole(torch.sum(m)), min=1.0)
    for l in range(len(params.gcn_w)):
        msg = torch.matmul(W, x)
        msg = msg @ params.gcn_w[l] + params.gcn_b[l]
        mean = whole(torch.sum(msg * m, dim=(0, 1, 2))) / cnt
        var = whole(torch.sum(((msg - mean) * m) ** 2, dim=(0, 1, 2))) / cnt
        msg = (msg - mean) / torch.sqrt(var + BN_EPS)
        msg = msg * params.bn_scale[l] + params.bn_offset[l]
        x = torch.relu(msg) * maskf[:, None, :, None]

    # causal masked self-attention over the T axis, per node; the diagonal
    # is never masked, so no row of the softmax is all -inf
    d = E // N_HEADS

    def heads(W_):
        return (x @ W_).reshape(B, T, N, N_HEADS, d).permute(0, 2, 3, 1, 4)  # (B, N, H, T, d)

    Q, K, V = heads(params.Wq), heads(params.Wk), heads(params.Wv)
    score = Q @ K.transpose(-1, -2) / float(np.sqrt(d))  # (B, N, H, T, T)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=W.device))
    score = torch.where(causal, score, -torch.inf)
    out = torch.softmax(score, dim=-1) @ V
    x = out.permute(0, 3, 1, 2, 4).reshape(B, T, N, E)

    # temporal aggregation with learned weights over the valid steps
    w_t = x @ params.Wagg  # (B, T, N, 1)
    t_mask = (torch.arange(T, device=W.device)[None, :] < lengths[:, None])[:, :, None, None]
    agg = torch.sum(w_t * x * t_mask, dim=1)  # (B, N, E)

    # the gated update against the whole embedding table
    beta = torch.zeros((B, n_items), dtype=torch.float32, device=W.device)
    beta = beta.scatter_reduce(1, safe_ids, maskf, reduce="amax")
    embed = params.emb[None] * (1.0 - beta[..., None] * params.alpha[None])
    update = gather_rows(params.alpha, flat_ids).reshape(B, N, 1) * agg
    embed = add_node_updates(embed, safe_ids, update * maskf[..., None])
    return (embed @ params.fc_w + params.fc_b)[..., 0]


def add_node_updates(embed, safe_ids, update):
    """``embed[b, safe_ids[b, j]] += update[b, j]`` (out of place; its
    gradient with respect to ``update`` is a gather). The only repeated
    targets are padded nodes, all at id 0 with zero updates, so the sum's
    value does not depend on the order in which the card adds them."""
    B, N = safe_ids.shape
    rows = torch.arange(B, device=safe_ids.device)[:, None].expand(B, N)
    return embed.index_put((rows, safe_ids), update, accumulate=True)


def take_columns(scores, cols):
    """``take_along_axis(scores, cols, 1)`` whose gradient sums in batch
    order (``gather_rows`` over the flattened scores)."""
    B, n = scores.shape
    flat = (torch.arange(B, device=cols.device)[:, None] * n + cols).reshape(-1)
    return gather_rows(scores.reshape(B * n, 1), flat).reshape(cols.shape)


def dnntsp_loss(loss_type, scores, yb, neg=None, cls_w=None, rows=None):
    """The JAX package's losses of one minibatch; ``neg`` (B, items) the
    ``bpr`` negatives, ``cls_w`` (items,) the ``weight_mse`` weights.
    ``rows``: on a mesh, the whole minibatch's rows, of which these are a
    rank's share (its terms over the whole minibatch's count,
    ``vaecf.batch_mean``; ``bpr`` is a sum already)."""
    cells = None if rows is None else rows * yb.shape[1]
    if loss_type == "bpr":
        neg_scores = take_columns(scores, neg)
        diff = scores - neg_scores
        valid = yb * (1.0 - torch.gather(yb, 1, neg))
        per_user = -torch.sum(F.logsigmoid(diff) * valid, dim=1) / torch.clamp(
            torch.sum(valid, dim=1), min=1.0)
        return torch.sum(per_user)
    if loss_type == "weight_mse":
        return batch_mean(torch.sum(cls_w[None] * (scores - yb) ** 2, dim=1), rows)
    if loss_type == "multi_label_soft_margin":
        return batch_mean(-(yb * F.logsigmoid(scores) + (1 - yb) * F.logsigmoid(-scores)), cells)
    return batch_mean((scores - yb) ** 2, cells)


class DNNTSP(NextBasketRecommender):
    """Temporal-sets prediction over per-user dynamic item graphs.

    Parameters mirror the JAX package's (``emb_dim``, ``loss_type``,
    ``optimizer``, ``lr``, ``weight_decay``, ``n_epochs``, ``batch_size``,
    ``seed``). ``device``: where it trains and scores (default: the card;
    ``"cpu"`` asks for the CPU; the JAX package's default ``"cpu"`` is a
    name it ignores)."""

    def __init__(
        self,
        name="DNNTSP",
        emb_dim=32,
        loss_type="bpr",
        optimizer="adam",
        lr=0.001,
        weight_decay=0,
        n_epochs=100,
        batch_size=64,
        device=None,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if loss_type not in LOSSES:
            raise ValueError("Unknown loss_type: {}".format(loss_type))
        if optimizer not in ("adam", "sgd", "rmsprop"):
            raise ValueError("Unknown optimizer: {}".format(optimizer))
        if emb_dim % N_HEADS != 0:
            raise ValueError("emb_dim must be divisible by %d heads" % N_HEADS)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.emb_dim = emb_dim
        self.loss_type = loss_type
        self.optimizer = optimizer
        self.lr = lr
        self.weight_decay = weight_decay
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.device = device
        self.seed = seed

    # ------------------------------------------------------- packing
    def _pack(self, histories, N, T):
        """Histories (lists of baskets) -> numpy graph blocks (node_ids (B,
        N) int64, node_mask (B, N) bool, W (B, T, N, N) float32, lengths
        (B,) int64): the last T baskets, the first N of their sorted items,
        each step's edges between its own items and every self-loop,
        weighted by the co-occurrence counts over the whole history over
        their maximum."""
        B = len(histories)
        node_ids = np.zeros((B, N), np.int64)
        node_mask = np.zeros((B, N), bool)
        W = np.zeros((B, T, N, N), np.float32)
        lengths = np.zeros(B, np.int64)
        for b, baskets in enumerate(histories):
            baskets = [np.unique(np.asarray(x, dtype=np.int64)) for x in baskets][-T:]
            lengths[b] = len(baskets)
            nodes = np.unique(np.concatenate(baskets))[:N] if baskets else np.zeros(0, np.int64)
            k = len(nodes)
            node_ids[b, :k] = nodes
            node_mask[b, :k] = True
            if not k:
                continue
            # member[t, p]: node p is in basket t; off the diagonal, the
            # counts of baskets two nodes share; on it, 1 (the JAX package's
            # dict of pairs, whose diagonal is set to 1 and never counted)
            member = np.zeros((len(baskets), k), dtype=bool)
            for t, bk in enumerate(baskets):
                at = np.minimum(np.searchsorted(nodes, bk), k - 1)
                member[t, at[nodes[at] == bk]] = True
            counts = member.T.astype(np.float64) @ member.astype(np.float64)
            np.fill_diagonal(counts, 1.0)
            weights = counts / counts.max()
            eye = np.eye(k, dtype=bool)
            for t in range(len(baskets)):
                W[b, t, :k, :k] = np.where(np.outer(member[t], member[t]) | eye, weights, 0.0)
        return node_ids, node_mask, W, lengths

    def _blocks(self, packed, device):
        return [torch.as_tensor(a, device=device) for a in packed]

    def loss_on(self, blocks, yb, neg=None, cls_w=None, share=None):
        """One minibatch's loss: ``blocks`` its graph blocks (tensors),
        ``neg`` its ``bpr`` negatives (B, items) int64, all the whole
        minibatch's; ``share`` (``parallel.sharded.Share``): this rank's
        share of it."""
        mine = (lambda x: x) if share is None else share.take
        scores = dnntsp_scores(self.params, *(mine(a) for a in blocks), share=share)
        return dnntsp_loss(self.loss_type, scores, mine(yb), None if neg is None else mine(neg),
                           cls_w, None if share is None else share.n)

    def _make_optimizer(self):
        if self.optimizer == "adam":
            if self.weight_decay:
                return adamw(self.lr, weight_decay=self.weight_decay)
            return adam(self.lr)
        return {"sgd": sgd, "rmsprop": rmsprop}[self.optimizer](self.lr)

    def _training_data(self, train_set, device):
        """(graph blocks, y, class weights) on ``device``: the blocks of each
        user's baskets but the last (padded to the largest history, whose
        sizes become ``_train_T`` and ``_train_N``), the last basket's
        multi-hot (users, items) and ``weight_mse``'s item weights; None
        when no user has two baskets."""
        histories, targets = [], []
        for _, _, [baskets] in train_set.ubi_iter(1, shuffle=False):
            if len(baskets) < 2:
                continue
            histories.append(baskets[:-1])
            targets.append(np.unique(baskets[-1]))
        if not histories:
            return None
        n = self.total_items
        self._train_T = max(len(h) for h in histories)
        self._train_N = max(len(set(i for bk in h for i in bk)) for h in histories)
        blocks = self._blocks(self._pack(histories, self._train_N, self._train_T), device)
        rows = np.repeat(np.arange(len(targets)), [len(t) for t in targets])
        y = torch.zeros((len(histories), n), dtype=torch.float32, device=device)
        y[torch.as_tensor(rows, device=device),
          torch.as_tensor(np.concatenate(targets).astype(np.int64), device=device)] = 1.0
        freq = np.bincount(train_set.uir_tuple[1], minlength=n).astype(np.float32)
        cls_w = torch.as_tensor(freq / max(freq.sum(), 1.0) + 1e-6, device=device)
        return blocks, y, cls_w

    # ----------------------------------------------------------- fit
    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        rng = get_rng(self.seed)
        n = self.total_items
        dev = self._device()
        self.params = _init_params(rng, n, self.emb_dim).to(dev)

        data = self._training_data(train_set, dev) if self.trainable else None
        if data is None:
            self._train_N = 1
            self._train_T = 1
            return self
        blocks, y_d, cls_w = data

        B_all = y_d.shape[0]
        bsz = min(self.batch_size, B_all)
        n_total = B_all + ((-B_all) % bsz)
        n_batches = n_total // bsz
        params = dict(self.params.named_parameters())
        opt = self._make_optimizer()
        opt_state = opt.init(params)
        seed = rng.randint(2**31)
        mesh = self.mesh
        share = None if mesh is None else Share(mesh, bsz)

        for e in range(self.n_epochs):
            gen = epoch_generator(seed, e, dev)
            perm = torch.randperm(n_total, generator=gen, device=dev) % B_all
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for b in range(n_batches):
                idx = perm[b * bsz:(b + 1) * bsz]
                neg = None
                if self.loss_type == "bpr":
                    neg = torch.randint(0, n, (bsz, n), generator=gen, device=dev)
                loss = self.loss_on([a[idx] for a in blocks], y_d[idx], neg, cls_w, share)
                opt_state = step(params, opt, opt_state, loss, mesh, None)
                loss_sum += loss.detach()
            if mesh is not None:  # the ranks' shares make the minibatches' losses
                all_sum(mesh, loss_sum, None)
            if self.verbose:
                print("Epoch %d/%d, loss: %.4f"
                      % (e + 1, self.n_epochs, float(loss_sum) / n_batches))
        return self

    # ------------------------------------------------------- scoring
    def score(self, user_idx, history_baskets, **kwargs):
        return self.score_baskets_batch([user_idx], [history_baskets])[0]

    def _scoring_blocks(self, histories):
        """(numpy graph blocks, B) of a scored batch: an empty history as
        one basket of item 0, T and N at least the training ones, the rows
        padded to a multiple of 64 (the batch statistics see the padding
        rows, as in the JAX package)."""
        histories = [h if len(h) else [[0]] for h in histories]
        T = max(self._train_T, max(len(h) for h in histories))
        N = max(self._train_N, max(len(set(i for bk in h for i in bk)) for h in histories))
        return pad_batch_rows(list(self._pack(histories, N, T)))

    def score_baskets_batch(self, user_indices, histories):
        packed, B = self._scoring_blocks(histories)
        dev = self.params.emb.device
        blocks = self._blocks(packed, dev)
        n = blocks[0].shape[0]
        with torch.no_grad():
            if self.mesh is not None and n % self.mesh.size() == 0:
                # the blocks split over the ranks, the statistics the whole
                # batch's, each rank's scores gathered
                share = Share(self.mesh, n)
                scores = data_parallel(
                    self.mesh, lambda *rows: dnntsp_scores(self.params, *rows, share=share),
                    n, *blocks, axis=None)
            else:
                scores = dnntsp_scores(self.params, *blocks)
        return scores.cpu().numpy().astype(np.float64)[:B]
