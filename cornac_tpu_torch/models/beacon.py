"""Beacon — correlation-sensitive next-basket recommendation (Le, Lauw &
Fang, IJCAI 2019).

Port of ``cornac_tpu/models/beacon.py``: the multi-hop normalised item
co-occurrence matrix (host scipy, as in the JAX package), the
correlation-gated basket encoder ``X·diag(relu(I_B)) + relu(X·A - |c|)``,
a dense layer, the LSTM / GRU / plain RNN over the baskets (``_rnn_scan``, a
Python loop over the T steps with step masks, as the JAX package's
``lax.scan``), and the correlation-adjusted sigmoid head with the paper's
positive-weighted loss, trained with RMSProp (``ops.optim.rmsprop``, optax's
rule).

Baskets are padded item-id tensors (B, T, L), padded with the id
``total_items``; the multi-hot (B, T, items) is a scatter of ones, which is
exact and deterministic (every write is the same 1.0). The correlation
matrix A is dense on the model's device, and ``X @ A`` and ``probs @ A`` are
``torch.matmul`` in full float32 (``ops.dispatch.full_f32``), as XLA
computes them. Every epoch draws its permutation and then each step's
dropout mask from one generator keyed on (seed, epoch): the same
distributions as the JAX package's threefry draws, another stream.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank:
each rank draws the whole stream, encodes its rows of a minibatch (their
dropout mask cut from the whole minibatch's) and sums their loss terms
over the whole minibatch's count (``vaecf.batch_mean``), and
``ops.optim.step`` sums the gradients. ``score_baskets_batch`` splits the
sequences over the ranks when their padded count divides the mesh, as the
JAX package shards them.
"""

from collections import Counter

import numpy as np
import scipy.sparse as sp
import torch

from ..engine.nn import Tree
from ..ops.dispatch import full_f32
from ..ops.optim import rmsprop, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, split_scoring
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .knn import dense_f32
from .recommender import NextBasketRecommender
from .seq_utils import pad_batch_rows
from .vaecf import batch_mean

EPS = 1e-8


def _init_cell(rng, in_dim, units, cell_type):
    bound = float(np.sqrt(6.0 / (in_dim + units)))

    def glorot(*shape):
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    gates = {"LSTM": 4, "GRU": 3, "RNN": 1}[cell_type]
    return Tree(wx=glorot(in_dim, gates * units), wh=glorot(units, gates * units),
                b=np.zeros(gates * units, np.float32))


def _rnn_scan(cell, x, lengths, units, cell_type):
    """Last valid hidden state (B, units) of the cell over x (B, T, E): a
    step t updates only the rows with t < lengths."""
    B, T, _ = x.shape
    H = units
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = h
    for t in range(T):
        xt = x[:, t]
        mask = (t < lengths)[:, None]
        if cell_type == "LSTM":
            gates = xt @ cell.wx + h @ cell.wh + cell.b
            i, f, g, o = torch.split(gates, H, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            c = torch.where(mask, c_new, c)
        elif cell_type == "GRU":
            zr = xt @ cell.wx[:, : 2 * H] + h @ cell.wh[:, : 2 * H]
            z, r = torch.split(torch.sigmoid(zr + cell.b[: 2 * H]), H, dim=-1)
            n = torch.tanh(xt @ cell.wx[:, 2 * H :] + (r * h) @ cell.wh[:, 2 * H :]
                           + cell.b[2 * H :])
            h_new = (1 - z) * n + z * h
        else:
            h_new = torch.tanh(xt @ cell.wx + h @ cell.wh + cell.b)
        h = torch.where(mask, h_new, h)
    return h


def _multi_hot(ids, n, dtype=torch.float32):
    """(B, T, L) item ids (pad id n) -> (B, T, n) multi-hot."""
    B, T, _ = ids.shape
    X = torch.zeros((B, T, n + 1), dtype=dtype, device=ids.device)
    X.scatter_(2, ids, 1.0)
    return X[..., :n]


def beacon_logits(params, A, ids, lengths, alpha, units, cell_type, drop=None, keep=1.0):
    """(B, items) logits of Beacon on padded baskets ``ids`` (B, T, L) with
    ``lengths`` (B,); ``drop`` (B, T, emb) 0/1 is the dropout mask of the
    encoded baskets (training), scaled by 1 / ``keep``."""
    n = A.shape[0]
    X = _multi_hot(ids, n, A.dtype)
    IB = torch.relu(params.I_B)
    with full_f32():
        enc = X * IB[None, None, :] + torch.relu(X @ A - torch.abs(params.C_Basket))
        enc = torch.relu(enc @ params.W_enc + params.b_enc)
        if drop is not None:
            enc = enc * drop / keep
        h_T = _rnn_scan(params.cell, enc, lengths, units, cell_type)
        probs = torch.sigmoid(h_T @ params.W_H)
        corr = probs * IB[None, :] + torch.relu(probs @ A)
    return (1.0 - alpha) * probs + alpha * corr


def beacon_loss(logits, y, denom=None):
    """The positive-weighted loss (the JAX package's ``Beacon._loss``); the
    row maximum and minimum share their gradient among ties, as JAX's do.
    ``denom``: on a mesh, the whole minibatch's count of terms, of which
    these rows are a rank's share (``vaecf.batch_mean``)."""
    sig = torch.sigmoid(logits)
    neg_y = 1.0 - y
    pos_logits = y * logits
    pos_max = torch.amax(pos_logits, dim=1, keepdim=True)
    pos_min = torch.amin(pos_logits + neg_y * pos_max, dim=1, keepdim=True)
    nb_pos = torch.clamp(torch.sum(y, dim=1), min=1.0)
    nb_neg = torch.sum(neg_y, dim=1)
    pos_weight = (nb_neg / nb_pos)[:, None]
    loss = y * -torch.log(sig + EPS) * pos_weight + neg_y * -torch.log(
        1.0 - torch.sigmoid(logits - pos_min) + EPS)
    return batch_mean(loss + EPS, denom)


class Beacon(NextBasketRecommender):
    """Correlation-sensitive basket-sequence model.

    Parameters mirror the JAX package's (``emb_dim``, ``rnn_unit``,
    ``alpha``, ``rnn_cell_type`` LSTM / GRU / RNN, ``dropout_rate``,
    ``nb_hop``, ``max_seq_length``, ``n_epochs``, ``batch_size``, ``lr``,
    ``seed``). ``device``: where it trains and scores (default: the card;
    ``"cpu"`` asks for the CPU)."""

    def __init__(
        self,
        name="Beacon",
        emb_dim=2,
        rnn_unit=4,
        alpha=0.5,
        rnn_cell_type="LSTM",
        dropout_rate=0.5,
        nb_hop=1,
        max_seq_length=None,
        n_epochs=15,
        batch_size=32,
        lr=0.001,
        device=None,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if rnn_cell_type not in ("LSTM", "GRU", "RNN"):
            raise ValueError("rnn_cell_type must be LSTM, GRU, or RNN")
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.emb_dim = emb_dim
        self.rnn_unit = rnn_unit
        self.alpha = alpha
        self.rnn_cell_type = rnn_cell_type
        self.dropout_rate = dropout_rate
        self.nb_hop = nb_hop
        self.max_seq_length = max_seq_length
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.lr = lr
        self.device = device
        self.seed = seed
        self.ignored_attrs.append("_A_dense")

    # ------------------------------------------------------ statistics
    def _normalize(self, adj):
        row_sum = np.asarray(adj.sum(1)).squeeze()
        d = np.power(row_sum, -0.5, out=np.zeros_like(row_sum, dtype="float32"),
                     where=row_sum != 0)
        D = sp.diags(d)
        return adj.dot(D).transpose().dot(D).tocsr()

    def _build_correlation_matrix(self, train_set, val_set, n_items):
        """Multi-hop normalised co-occurrence of the items of each basket."""
        if self.nb_hop == 0:
            return sp.csr_matrix((n_items, n_items), dtype="float32")
        # the number of baskets each pair a < b of distinct items shares:
        # the upper triangle of B^T B for the binary baskets x items matrix
        # B of each split (the JAX package counts the pairs one at a time in
        # a Counter; the same integers, so the same matrix)
        shared = sp.csr_matrix((n_items, n_items), dtype=np.int64)
        for ds in (train_set, val_set):
            if ds is None:
                continue
            B = sp.csr_matrix((np.ones(len(ds.basket_indices), np.int64),
                               (ds.basket_indices, ds.uir_tuple[1])),
                              shape=(int(ds.basket_indices.max()) + 1, n_items))
            B.data[:] = 1
            shared = shared + sp.triu(B.T @ B, k=1).tocsr()
        shared = shared.tocoo()
        if not shared.nnz:
            return sp.csr_matrix((n_items, n_items), dtype="float32")
        data, row, col = shared.data, shared.row, shared.col
        corr = sp.csc_matrix((data, (row, col)), shape=(n_items, n_items), dtype="float32")
        corr = self._normalize(corr)
        w_mul, coeff = corr, 1.0
        for _ in range(1, self.nb_hop):
            coeff *= 0.85
            w_mul = w_mul * corr
            w_mul.setdiag(0.0)
            w_mul.eliminate_zeros()
            corr = corr + coeff * self._normalize(w_mul)
        return corr

    def _compute_item_probs(self, train_set, val_set, n_items):
        freq = Counter(train_set.uir_tuple[1].tolist())
        total = len(train_set.uir_tuple[1])
        if val_set is not None:
            freq += Counter(val_set.uir_tuple[1].tolist())
            total += len(val_set.uir_tuple[1])
        probs = np.zeros(n_items, np.float32)
        for iid, cnt in freq.items():
            probs[iid] = cnt / total
        return probs

    # ------------------------------------------------------- packing
    def _pack(self, sequences):
        """List of basket sequences -> (ids (B, T, L), lengths (B,)) int64.
        Sequences keep their last ``max_seq_length`` baskets; the pad id is
        ``total_items`` (dropped after the multi-hot scatter)."""
        T = self.max_seq_length
        L = max(max((len(b) for seq in sequences for b in seq), default=1), 1)
        ids = np.full((len(sequences), T, L), self.total_items, np.int64)
        lengths = np.zeros(len(sequences), np.int64)
        for s, seq in enumerate(sequences):
            seq = seq[-T:]
            lengths[s] = len(seq)
            for t, basket in enumerate(seq):
                basket = list(basket)[:L]
                ids[s, t, : len(basket)] = basket
        return ids, lengths

    def _A(self):
        """The correlation matrix, dense on the model's device (built once a
        fit, and again after unpickling)."""
        if getattr(self, "_A_dense", None) is None:
            self._A_dense = dense_f32(self.correlation_matrix, self._device())
        return self._A_dense

    def logits(self, ids, lengths, drop=None):
        """(B, items) logits of padded baskets (tensors on the model's
        device), ``drop`` the training dropout mask (B, T, emb_dim) or None."""
        return beacon_logits(self.params, self._A(), ids, lengths, self.alpha,
                             self.rnn_unit, self.rnn_cell_type, drop, 1.0 - self.dropout_rate)

    def loss_on(self, ids, lengths, y, drop, share=None):
        """One minibatch's loss on the given dropout mask (or None), all the
        whole minibatch's; ``share`` (``parallel.sharded.Share``): this
        rank's share of it."""
        mine = (lambda x: x) if share is None else share.take
        logits = self.logits(mine(ids), mine(lengths), None if drop is None else mine(drop))
        return beacon_loss(logits, mine(y), None if share is None else share.n * y.shape[1])

    def _drop_mask(self, generator, shape, device):
        """The dropout mask of a step (None without dropout): a Bernoulli of
        the keep probability, as ``jax.random.bernoulli`` draws it."""
        if self.dropout_rate <= 0:
            return None
        u = torch.rand(shape, generator=generator, device=device)
        return (u < 1.0 - self.dropout_rate).to(torch.float32)

    def _training_data(self, train_set, device):
        """(ids, lengths, y) on ``device`` of the training sequences: each
        user's baskets but the last, packed, and the last basket's
        multi-hot (sequences, items); None when no user has two baskets."""
        seqs, targets = [], []
        for _, _, [baskets] in train_set.ubi_iter(1, shuffle=False):
            if len(baskets) < 2:
                continue
            seqs.append(baskets[:-1])
            targets.append(baskets[-1])
        if not seqs:
            return None
        ids, lengths = self._pack(seqs)
        rows = np.repeat(np.arange(len(targets)), [len(t) for t in targets])
        y = torch.zeros((len(seqs), self.total_items), dtype=torch.float32, device=device)
        y[torch.as_tensor(rows, device=device),
          torch.as_tensor(np.concatenate(targets).astype(np.int64), device=device)] = 1.0
        return torch.as_tensor(ids, device=device), torch.as_tensor(lengths, device=device), y

    # ----------------------------------------------------------- fit
    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        rng = get_rng(self.seed)
        n = self.total_items
        dev = self._device()

        if self.max_seq_length is None:
            self.max_seq_length = max(len(b) for b in train_set.user_basket_data.values())
        self.correlation_matrix = self._build_correlation_matrix(train_set, val_set, n)
        self.item_probs = self._compute_item_probs(train_set, val_set, n)
        self._A_dense = None
        self._A()  # on the device before any epoch, so no step copies it there

        he = float(np.sqrt(6.0 / n))
        wh_bound = float(np.sqrt(6.0 / (self.rnn_unit + n)))
        self.params = Tree(
            I_B=np.full((n,), 1.0 / n, np.float32),
            C_Basket=np.float32(self.correlation_matrix.mean()),
            W_enc=rng.uniform(-he, he, size=(n, self.emb_dim)).astype(np.float32),
            b_enc=np.zeros((self.emb_dim,), np.float32),
            cell=_init_cell(rng, self.emb_dim, self.rnn_unit, self.rnn_cell_type),
            W_H=rng.uniform(-wh_bound, wh_bound, size=(self.rnn_unit, n)).astype(np.float32),
        ).to(dev)
        if not self.trainable:
            return self

        data = self._training_data(train_set, dev)
        if data is None:
            return self
        ids_d, len_d, y_d = data

        N = ids_d.shape[0]
        bsz = min(self.batch_size, N)
        n_total = N + ((-N) % bsz)
        n_batches = n_total // bsz
        params = dict(self.params.named_parameters())
        opt = rmsprop(self.lr)
        opt_state = opt.init(params)
        seed = rng.randint(2**31)
        drop_shape = (bsz, self.max_seq_length, self.emb_dim)
        mesh = self.mesh
        share = None if mesh is None else Share(mesh, bsz)

        for e in range(self.n_epochs):
            gen = epoch_generator(seed, e, dev)
            perm = torch.randperm(n_total, generator=gen, device=dev) % N
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for b in range(n_batches):
                idx = perm[b * bsz:(b + 1) * bsz]
                loss = self.loss_on(ids_d[idx], len_d[idx], y_d[idx],
                                    self._drop_mask(gen, drop_shape, dev), share)
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

    def score_baskets_batch(self, user_indices, histories):
        histories = [h if len(h) else [[]] for h in histories]
        ids, lengths = self._pack(histories)
        # the basket width padded to a multiple of 8 and the rows to a
        # multiple of 64, as the JAX package pads them
        width_pad = (-ids.shape[2]) % 8
        if width_pad:
            ids = np.concatenate(
                [ids, np.full(ids.shape[:2] + (width_pad,), self.total_items, np.int64)], axis=2)
        (ids, lengths), B = pad_batch_rows([ids, lengths])
        dev = self._A().device
        ids_d, len_d = torch.as_tensor(ids, device=dev), torch.as_tensor(lengths, device=dev)

        def scores(ids, lengths):
            return torch.sigmoid(self.logits(ids, lengths))

        with torch.no_grad():
            out = split_scoring(self.mesh, scores, ids.shape[0], ids_d, len_d)
        return out.cpu().numpy().astype(np.float64)[:B]
