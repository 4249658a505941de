"""ConvMF — Convolutional Matrix Factorization (Kim et al., RecSys 2016).

Port of ``cornac_tpu/models/convmf.py``: each epoch solves (U, V) by ALS on
the model's device (batched k x k solves over the padded layouts, the item
side pulled toward the CNN's document vectors ``theta`` with per-item
weights), then trains the CNN (word embeddings, convolutions of widths
``filter_sizes`` with ReLU and a max-pool over the positions, two tanh
layers) by Adam to regress the item factors from the documents. The
convolution is a window unfold and one product (``review_utils.windows``),
not ``conv1d``, so its weight gradient is deterministic. The CNN's order is
``rng.permutation`` of the items from the fit's numpy generator, tiled to
whole minibatches, as the JAX package draws it, so a port fit follows the
JAX fit itself. The gradient of the embedding gather sums through
``accumulate_rows``.

``mesh`` (``parallel.make_mesh``), as in the JAX package: the ALS rows are
split over "data" (each row is its own k x k solve, so the slices give the
plain solves' bits), and the CNN's minibatches, rounded down to a multiple
of the data axis, are data-parallel over "data": each rank takes the loss
of its data slice and ``ops.optim.step`` sums the gradients over "data".
That sum takes another order than one device's backward, so the CNN agrees
with the plain fit to float32 rounding, and bit for bit on a mesh of one
rank.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot
from ..ops.optim import adam, step
from ..parallel.mesh import DATA_AXIS, check_mesh
from ..parallel.sharded import batch_slice, data_parallel, round_batch
from ..utils import get_rng
from .cdl import dense_arrays, require_text
from .cvae import host_order, padded_layouts
from .recommender import Recommender, pad_to_catalog
from .review_utils import windows

DOC_ROWS = 1024  # documents the CNN encodes at once outside training


def init_cnn(rng, vocab, emb_dim, filter_sizes, num_filters, hidden, out_dim):
    """The CNN's initial parameters from ``rng`` in the JAX package's
    order (the embeddings, the two dense layers, then the convolutions), as
    a flat dict of float32 arrays."""
    params = {"emb": rng.uniform(-1, 1, (vocab, emb_dim)).astype(np.float32)}
    params.update(dense_arrays(rng, num_filters * len(filter_sizes), hidden, "fc1"))
    params.update(dense_arrays(rng, hidden, out_dim, "fc2"))
    for j, fs in enumerate(filter_sizes):
        bound = 1.0 / np.sqrt(fs * emb_dim)
        params[f"convs.{j}.w"] = rng.uniform(-bound, bound, (fs, emb_dim, num_filters)).astype(
            np.float32)
        params[f"convs.{j}.b"] = np.zeros(num_filters, np.float32)
    return params


def cnn_forward(params, docs, filter_sizes):
    """(B, L) token ids -> (B, out_dim) document vectors: the embeddings'
    VALID convolutions, ReLU, the maximum over the positions, then
    tanh(fc1), tanh(fc2)."""
    E = params["emb"].shape[1]  # explicit widths: a rank's share may hold no documents
    x = gather_rows(params["emb"], docs.reshape(-1)).reshape(docs.shape + (E,))
    feats = []
    for j, fs in enumerate(filter_sizes):
        w = params[f"convs.{j}.w"]
        win = windows(x, fs)
        y = win.reshape(*win.shape[:-2], fs * E) @ w.reshape(-1, w.shape[-1]) + params[
            f"convs.{j}.b"]
        feats.append(torch.amax(torch.relu(y), dim=1))
    h = torch.tanh(torch.cat(feats, dim=1) @ params["fc1.w"] + params["fc1.b"])
    return torch.tanh(h @ params["fc2.w"] + params["fc2.b"])


def als_users(V, pad, lambda_u, mesh=None):
    """Each user's ridge solve over its observed items. ``mesh``: the rows
    are split over "data" and gathered back (``data_parallel``)."""
    eye = torch.eye(V.shape[1], device=V.device)[None]

    def solve(pad_idx, pad_val, pad_mask):
        Vs = V[pad_idx] * pad_mask[:, :, None]
        A = torch.einsum("blk,blm->bkm", Vs, Vs) + lambda_u * eye
        rhs = torch.einsum("blk,bl->bk", Vs, pad_val * pad_mask)
        return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]

    return data_parallel(mesh, solve, pad[0].shape[0], *pad)


def als_items(U, theta, weights, pad, lambda_v, mesh=None):
    """Each item's ridge solve over its observed users, pulled toward its
    document vector ``theta`` with weight ``lambda_v * weights``. ``mesh``:
    as ``als_users``."""
    eye = torch.eye(U.shape[1], device=U.device)[None]

    def solve(pad_idx, pad_val, pad_mask, theta_rows, weight_rows):
        Us = U[pad_idx] * pad_mask[:, :, None]
        lw = lambda_v * weight_rows
        A = torch.einsum("blk,blm->bkm", Us, Us) + lw[:, None, None] * eye
        rhs = torch.einsum("blk,bl->bk", Us, pad_val * pad_mask) + lw[:, None] * theta_rows
        return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]

    return data_parallel(mesh, solve, pad[0].shape[0], *pad, theta, weights)


def cnn_loss(cnn, docs, target, weight, filter_sizes):
    """sum weight (CNN(docs) - target)^2, the CNN's regression loss."""
    pred = cnn_forward(cnn, docs, filter_sizes)
    return (weight[:, None] * (pred - target) ** 2).sum()


class ConvMF(Recommender):
    """CNN-text-regularised MF solved by alternating ALS and CNN regression.

    Parameters mirror the JAX package: ``k``, ``n_epochs``, ``cnn_epochs``,
    ``cnn_bs``, ``cnn_lr``, ``lambda_u``, ``lambda_v``, ``emb_dim``,
    ``max_len``, ``filter_sizes``, ``num_filters``, ``hidden_dim``,
    ``dropout_rate`` (unused, as there), ``give_item_weight``,
    ``init_params`` ({'U', 'V', 'W'}), ``seed``. ``device``: where the model
    trains and scores (default: the card). ``mesh``: a
    ``parallel.make_mesh`` mesh; every rank calls ``fit`` (module
    docstring).
    """

    def __init__(
        self,
        name="ConvMF",
        k=50,
        n_epochs=50,
        cnn_epochs=5,
        cnn_bs=128,
        cnn_lr=0.001,
        lambda_u=1,
        lambda_v=100,
        emb_dim=200,
        max_len=300,
        filter_sizes=(3, 4, 5),
        num_filters=100,
        hidden_dim=200,
        dropout_rate=0.2,
        give_item_weight=True,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.n_epochs = n_epochs
        self.cnn_epochs = cnn_epochs
        self.cnn_bs = cnn_bs
        self.cnn_lr = cnn_lr
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.emb_dim = emb_dim
        self.max_len = max_len
        self.filter_sizes = list(filter_sizes)
        self.num_filters = num_filters
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate
        self.give_item_weight = give_item_weight
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)
        self.W = self.init_params.get("W", None)

    def encode(self, cnn, docs):
        """The CNN's document vectors of every row of ``docs`` (a device
        tensor), ``DOC_ROWS`` documents at a time, with no gradient."""
        with torch.no_grad():
            return torch.cat([cnn_forward(cnn, docs[s: s + DOC_ROWS], self.filter_sizes)
                              for s in range(0, docs.shape[0], DOC_ROWS)])

    def cnn_step(self, cnn, opt, opt_state, docs, target, weight):
        """One Adam step of the CNN's regression, ``cnn`` updated in place.
        Returns (the new state, the loss). On a mesh the rows are this
        rank's data slice of the minibatch, the gradients summed over
        "data"."""
        loss = cnn_loss(cnn, docs, target, weight, self.filter_sizes)
        return step(cnn, opt, opt_state, loss, self.mesh), loss.detach()

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        require_text(train_set)
        rng = get_rng(self.seed)
        if self.U is None:
            self.U = rng.uniform(size=(self.num_users, self.k)).astype(np.float32)
        if self.V is None:
            self.V = rng.uniform(size=(self.num_items, self.k)).astype(np.float32)
        if not self.trainable:
            return self

        csr = train_set.matrix
        item_counts = np.diff(csr.T.tocsr().indptr)
        if self.give_item_weight:
            w = np.sqrt(np.maximum(item_counts, 1)).astype(np.float64)
            item_weight = (self.num_items / w.sum()) * w
        else:
            item_weight = np.ones(self.num_items)
        docs = train_set.item_text.batch_seq(np.arange(self.num_items),
                                             max_length=self.max_len).astype(np.int64)
        vocab = train_set.item_text.vocab.size
        dev = self._device()
        cnn = {n: torch.tensor(a, device=dev, requires_grad=True) for n, a in init_cnn(
            rng, vocab, self.emb_dim, self.filter_sizes, self.num_filters, self.hidden_dim,
            self.k).items()}
        opt = adam(self.cnn_lr)
        opt_state = opt.init(cnn)
        u_pad, i_pad = padded_layouts(csr, dev)
        weights = torch.as_tensor(item_weight.astype(np.float32), device=dev)
        docs_d = torch.as_tensor(docs, device=dev)
        V = torch.as_tensor(np.asarray(self.V, np.float32), device=dev)
        theta = self.encode(cnn, docs_d)
        mesh = self.mesh
        bsz = round_batch(mesh, min(self.cnn_bs, self.num_items), DATA_AXIS)
        rows = slice(None) if mesh is None else slice(*batch_slice(mesh, bsz)[:2])
        for epoch in range(self.n_epochs):
            with torch.no_grad():
                U = als_users(V, u_pad, self.lambda_u, mesh)
                V = als_items(U, theta, weights, i_pad, self.lambda_v, mesh)
            for _ in range(self.cnn_epochs):
                order = rng.permutation(self.num_items)
                starts = range(0, self.num_items, bsz)
                ids = host_order(np.concatenate([np.resize(order[s: s + bsz], bsz)
                                                 for s in starts]), dev)
                for b in range(len(starts)):
                    idx = ids[b * bsz: (b + 1) * bsz][rows]
                    opt_state, _ = self.cnn_step(cnn, opt, opt_state, docs_d[idx], V[idx],
                                                 weights[idx])
            theta = self.encode(cnn, docs_d)
            if self.verbose:
                print("Epoch %d/%d done" % (epoch + 1, self.n_epochs))

        if self.n_epochs > 0:
            self.U = U.cpu().numpy()
        self.V = V.cpu().numpy()
        self.theta = theta.cpu().numpy()
        self.cnn = {n: p.detach() for n, p in cnn.items()}
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self.V @ self.U[user_idx]
        return self.V[item_idx] @ self.U[user_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = (self.U[np.where(known, users, 0)] @ self.V.T).astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def _known_scores_device(self, safe_users, known):
        return device_dot(np.asarray(self.U, np.float32)[safe_users], self.V, self._device())
