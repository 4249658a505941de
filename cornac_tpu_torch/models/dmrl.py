"""DMRL — Disentangled Multimodal Representation Learning for
recommendation (Liu et al., 2022, arXiv:2203.05406).

Port of ``cornac_tpu/models/dmrl.py``: user/item/text/image embeddings
split into disentangled factor chunks, per-factor modality attention,
softplus ratings summed over factors and modalities, the pairwise softplus
ranking loss against the hardest of ``num_neg`` sampled negatives, plus a
distance-correlation disentanglement penalty; AdamW (optax's rule,
``ops.optim.adamw``).

Factor chunks are a reshape ``(B, S, n_factors, fs)``, so all factors run
in one batched product. Each epoch takes its draws from one
``torch.Generator`` seeded from (the fit's seed, the global epoch index):
the order (a permutation of |R| rounded up to whole minibatches, modulo
|R|), then each step's negatives and dropout keep masks in a fixed order
(``DMRL.draws``), which a test can replace with the JAX key's own draws
(``negatives`` from fold-in 7; the modality MLPs' masks from fold-ins 0 and
1 of fold-ins 11 (text) and 13 (image); the attention input's from
fold-in 17). The gradients of the embedding gathers sum through
``accumulate_rows``. Deviations (documented): the reference encodes raw
text with a HuggingFace sentence-transformer (no-egress here) — raw
``TextModality`` corpora fall back to TF-IDF features while precomputed
``FeatureModality`` features are used as-is; the reference's attention
indexes slot 1 for BOTH text and image (recom_dmrl bug when both are
present) — slots here are per-modality; the reference hardcodes
``decay_c=1e-3`` in fit regardless of the constructor argument — here the
constructor argument is honored; distance correlation runs over all factor
pairs i<j (the reference's loop bounds skip the last factor).

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank,
the minibatch rounded down to a multiple of the mesh's size as in the JAX
package: every rank draws the whole stream (the negatives and keep masks
of the whole minibatch), sums the ranking terms of its rows, and
``ops.optim.step`` sums the gradients. The distance correlation couples
every row of a minibatch, so rank 0 adds it over the whole minibatch's
first slot, which it encodes once more.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dispatch import full_f32
from ..ops.optim import adamw, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from .mf import _epoch_permutation
from .recommender import Recommender, pad_to_catalog
from .vbpr import softplus

EPS = 1e-5
HIDDEN = 150  # the modality MLPs' hidden width
SCORE_CELLS = 1 << 18  # (user, item) cells a scoring chunk holds


def _xavier_normal(rng, shape):
    std = float(np.sqrt(2.0 / (shape[0] + shape[1])))
    return rng.normal(0.0, std, size=shape).astype(np.float32)


def _init_mlp2(rng, in_dim, hid, out):
    return {"w1": _xavier_normal(rng, (in_dim, hid)), "b1": np.zeros((hid,), np.float32),
            "w2": _xavier_normal(rng, (hid, out)), "b2": np.zeros((out,), np.float32)}


def _leaky_relu(x):
    """``jax.nn.leaky_relu``: the slope 1 at 0 (torch's takes 0.01 there,
    which a dropped input row with the zero initial bias reaches)."""
    return torch.where(x >= 0, x, 0.01 * x)


def _normalise(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), EPS)


def _modality_mlp(p, name, x, masks, keep):
    """The two-layer modality MLP on the L2-normalised features, the keep
    masks ``masks[name + "0"]`` (input) and ``masks[name + "1"]`` (hidden)
    applied when given."""
    x = _normalise(x)
    if masks is not None:
        x = x * masks[name + "0"] / keep
    h = _leaky_relu(x @ p[name + ".w1"] + p[name + ".b1"])
    if masks is not None:
        h = h * masks[name + "1"] / keep
    return _leaky_relu(h @ p[name + ".w2"] + p[name + ".b2"])


def dmrl_forward(params, u, items, masks, text, image, F, fs, keep, per_item=False):
    """u: (B,), items: (B, S) — S sample slots. Returns (ratings (B, S),
    the factor chunks {name: (B, S, F, fs)}). ``masks``: the step's keep
    masks (None in evaluation). ``per_item``: the modality MLPs run once
    over every item and their rows are gathered (evaluation, with no masks
    and no gradient), where training runs them on each slot's features."""
    B, S = items.shape
    flat = items.reshape(-1)
    ue = gather_rows(params["user_emb"], u)[:, None, :].expand(B, S, -1)
    ie = gather_rows(params["item_emb"], flat).reshape(B, S, -1)
    chunks = {"user": ue.reshape(B, S, F, fs), "item": ie.reshape(B, S, F, fs)}
    for name, feats in (("text", text), ("image", image)):
        if feats is None:
            continue
        if per_item:
            out = _modality_mlp(params, name + "_mlp", feats, None, keep)[flat]
        else:
            out = _modality_mlp(params, name + "_mlp", feats[flat].reshape(B, S, -1), masks, keep)
        chunks[name] = out.reshape(B, S, F, fs)

    cat = _normalise(torch.cat(list(chunks.values()), dim=-1))  # (B, S, F, (m+1) fs)
    if masks is not None:
        cat = cat * masks["att"] / keep
    a = torch.tanh(cat @ params["att_w1"] + params["att_b1"])
    att = torch.softmax(a @ params["att_w2"], dim=-1)  # (B, S, F, m)

    user = chunks["user"]
    r = att[..., 0] * softplus((user * chunks["item"]).sum(-1))
    for slot, name in enumerate((n for n in ("text", "image") if n in chunks), start=1):
        r = r + att[..., slot] * softplus((user * chunks[name]).sum(-1))
    return r.sum(-1), chunks  # summed over the factors


def dist_corr_pairs(chunks):
    """The summed distance correlations of every factor pair i < j within
    each of the chunks ``chunks`` (M, B, F, fs), as ``d_cor_calc.py``
    computes each with the same 1e-5 floors: each factor's
    double-centred distance matrix made once, in one batched product for
    all M x F factors (the JAX package makes each pair's two again), then
    the pairs' covariances from them."""
    M, B, F, fs = chunks.shape
    X = chunks.permute(0, 2, 1, 3).reshape(M * F, B, fs)
    sq = (X ** 2).sum(-1, keepdim=True)
    D = torch.sqrt(torch.clamp_min(sq - 2 * X @ X.transpose(1, 2) + sq.transpose(1, 2), EPS))
    C = D - D.mean(2, keepdim=True) - D.mean(1, keepdim=True) + D.mean((1, 2), keepdim=True)

    def cov(a, b):
        return torch.sqrt(torch.clamp_min((a * b).sum((1, 2)) / (B * B), EPS))

    own = cov(C, C)  # each factor with itself
    i, j = torch.triu_indices(F, F, 1, device=chunks.device)  # made on the device: no copy
    base = torch.arange(M, device=chunks.device)[:, None] * F
    ia, ib = (base + i).reshape(-1), (base + j).reshape(-1)
    return (cov(C[ia], C[ib]) / torch.sqrt(torch.clamp_min(own[ia] * own[ib], 0.0) + EPS)).sum()


def dmrl_loss(params, u, pos, draws, text, image, F, fs, keep, decay_c, share=None):
    """The JAX package's ``loss_fn`` on the users ``u`` and positives
    ``pos`` with the step's draws ``(negatives (B, num_neg), keep masks or
    None)``: the summed softplus of the hardest negative's margin, plus
    ``decay_c`` times the mean distance correlation of the factor pairs of
    every chunk in the first sample slot (the JAX package computes every
    slot and keeps the first), all pairs in one batch (``dist_corr_pairs``).
    ``share`` (``parallel.sharded.Share``): the minibatch and its draws are
    whole, and this rank takes the terms of its rows; the first rank adds
    the distance correlation, encoding every row's first slot."""
    neg, masks = draws
    items = torch.cat([pos[:, None], neg], dim=1)
    mine = (lambda x: x) if share is None else share.take
    ratings, chunks = dmrl_forward(params, mine(u), mine(items), None if masks is None else
                                   {k: mine(m) for k, m in masks.items()},
                                   text, image, F, fs, keep)
    loss = softplus(-(ratings[:, 0] - ratings[:, 1:].max(1).values)).sum()
    if decay_c > 0 and share is not None and not share.whole:
        # every row's first slot, on the rank that adds the correlation
        chunks = None if not share.first else dmrl_forward(
            params, u, pos[:, None], None if masks is None else
            {k: m[:, :1] for k, m in masks.items()}, text, image, F, fs, keep)[1]
    if decay_c > 0 and chunks is not None:
        cor = dist_corr_pairs(torch.stack([c[:, 0] for c in chunks.values()]))
        loss = loss + decay_c * (cor / ((F + 1.0) * F / 2.0))
    return loss


class DMRL(Recommender):
    """Disentangled multimodal ranking model.

    Parameters mirror the JAX package: ``batch_size``, ``learning_rate``,
    ``decay_c`` (the disentanglement weight), ``decay_r`` (AdamW's weight
    decay), ``epochs``, ``embedding_dim``, ``bert_text_dim`` and
    ``image_dim`` (kept for the signature: the widths come from the
    modalities), ``dropout``, ``num_neg``, ``num_factors``,
    ``log_metrics``, ``seed``. ``device``: where the model trains and
    scores (default: the card). ``mesh``: a ``parallel.make_mesh`` mesh;
    every rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="DMRL",
        batch_size=32,
        learning_rate=1e-4,
        decay_c=1.0,
        decay_r=0.01,
        epochs=10,
        embedding_dim=100,
        bert_text_dim=384,
        image_dim=None,
        dropout=0.0,
        num_neg=4,
        num_factors=4,
        trainable=True,
        verbose=False,
        log_metrics=False,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.decay_c = decay_c
        self.decay_r = decay_r
        self.epochs = epochs
        self.embedding_dim = embedding_dim
        self.text_dim = bert_text_dim
        self.image_dim = image_dim
        self.dropout = dropout
        self.num_neg = num_neg
        self.num_factors = num_factors
        self.log_metrics = log_metrics
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        if embedding_dim % num_factors != 0:
            raise ValueError("embedding_dim must be divisible by num_factors")
        if num_factors == 1:
            self.decay_c = 0.0  # disentangled loss needs >= 2 factors

    def _item_features(self, train_set):
        """(text_feats, image_feats) as dense host arrays or None: the text
        modality's ``features``, else TF-IDF over its ``count_matrix``."""
        text = None
        if train_set.item_text is not None:
            mod = train_set.item_text
            feats = getattr(mod, "features", None)
            if feats is not None:
                text = np.asarray(feats.todense() if hasattr(feats, "todense") else feats,
                                  np.float32)[: self.num_items]
            elif getattr(mod, "count_matrix", None) is not None:
                # the fallback: TF-IDF over the item corpus (no
                # sentence-transformer in this environment)
                cm = mod.count_matrix[: self.num_items]
                df = np.asarray((cm > 0).sum(axis=0)).ravel() + 1.0
                idf = np.log((cm.shape[0] + 1.0) / df) + 1.0
                text = np.asarray(cm.todense(), np.float32) * idf[None, :]
        image = None
        if train_set.item_image is not None:
            feats = train_set.item_image.features
            if feats is not None:
                image = np.asarray(feats.todense() if hasattr(feats, "todense") else feats,
                                   np.float32)[: self.num_items]
        return text, image

    def _initial(self, rng, text, image):
        """The initial parameters (numpy float32, flat names), drawn from
        ``rng`` in the JAX package's order."""
        D, n_mod = self.embedding_dim, self._n_mod
        fs = D // self.num_factors
        out = {"user_emb": _xavier_normal(rng, (self.num_users, D)),
               "item_emb": _xavier_normal(rng, (self.num_items, D)),
               "att_w1": _xavier_normal(rng, ((n_mod + 1) * fs, n_mod)),
               "att_b1": np.zeros((n_mod,), np.float32),
               "att_w2": _xavier_normal(rng, (n_mod, n_mod))}
        for name, feats in (("text_mlp", text), ("image_mlp", image)):
            if feats is not None:
                for key, value in _init_mlp2(rng, feats.shape[1], HIDDEN, D).items():
                    out[f"{name}.{key}"] = value
        return out

    def mask_shapes(self, B):
        """{name: shape} of a step's keep masks for B users, in the order
        ``draws`` makes them."""
        S, D = 1 + self.num_neg, self.embedding_dim
        shapes = {}
        for name, feats in (("text_mlp", self._text), ("image_mlp", self._image)):
            if feats is not None:
                shapes[name + "0"] = (B, S, feats.shape[1])
                shapes[name + "1"] = (B, S, HIDDEN)
        F = self.num_factors
        shapes["att"] = (B, S, F, (self._n_mod + 1) * (D // F))
        return shapes

    def draws(self, gen, B):
        """A step's draws from ``gen``: the (B, num_neg) negatives, then, with
        dropout, one float32 keep mask per ``mask_shapes`` entry (None
        without)."""
        dev = gen.device
        neg = torch.randint(self.num_items, (B, self.num_neg), generator=gen, device=dev)
        if self.dropout <= 0:
            return neg, None
        keep = 1.0 - self.dropout
        return neg, {name: (torch.rand(shape, generator=gen, device=dev) < keep).to(torch.float32)
                     for name, shape in self.mask_shapes(B).items()}

    def loss_on(self, params, u, pos, draws, share=None):
        """The loss of a step (``dmrl_loss``) on this model's modalities;
        ``share``: this rank's share of it."""
        F = self.num_factors
        return dmrl_loss(params, u, pos, draws, self._text, self._image, F,
                         self.embedding_dim // F, 1.0 - self.dropout, self.decay_c, share)

    def epoch(self, params, opt, opt_state, order, pairs, step_draws, batch_size):
        """One epoch of AdamW steps in the order ``order``, each step's draws
        from ``step_draws(B)``, updating ``params`` in place. Returns (the
        new state, the summed loss). On the model's mesh, each rank takes
        its share of every minibatch (module docstring)."""
        mesh = getattr(self, "mesh", None)
        share = None if mesh is None else Share(mesh, batch_size)
        loss_sum = torch.zeros((), dtype=torch.float32, device=pairs.device)
        for s in range(0, order.shape[0], batch_size):
            u, pos = pairs[order[s:s + batch_size]].unbind(1)
            loss = self.loss_on(params, u, pos, step_draws(u.shape[0]), share)
            opt_state = step(params, opt, opt_state, loss, mesh, None)
            loss_sum += loss.detach()
        if mesh is not None:  # the ranks' shares make the minibatches' losses
            all_sum(mesh, loss_sum, None)
        return opt_state, loss_sum

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        text, image = self._item_features(train_set)
        if text is None and image is None:
            raise ValueError("DMRL requires an item_text or item_image modality")
        self._n_mod = 1 + (text is not None) + (image is not None)
        dev = self._device()
        self._text, self._image = (None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=dev) for a in (text, image))
        params = {name: torch.tensor(a, device=dev, requires_grad=True)
                  for name, a in self._initial(rng, text, image).items()}

        uid, iid, _ = train_set.uir_tuple
        n = len(uid)
        pairs = torch.as_tensor(np.stack([uid, iid], axis=1).astype(np.int64), device=dev)
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_total = n + ((-n) % bsz)
        opt = adamw(self.learning_rate, b1=0.9, b2=0.999, weight_decay=self.decay_r)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                gen = epoch_generator(seed, epoch, dev)
                order = _epoch_permutation(n_total, gen) % n
                opt_state, loss = self.epoch(params, opt, opt_state, order, pairs,
                                             lambda B: self.draws(gen, B), bsz)
            return opt_state, loss

        epoch_loop(self, self.epochs, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Epoch %d/%d, loss: %.4f" % (done, self.epochs, float(loss))))

        self.params = {name: t.detach() for name, t in params.items()}
        return self

    def _score_users(self, users):
        """(B, num_items) evaluation-mode scores on the model's device, in
        chunks of users, the modality MLPs run once over the items (the JAX
        package runs them again for every user)."""
        F = self.num_factors
        fs = self.embedding_dim // F
        dev = self.params["user_emb"].device
        users = torch.as_tensor(np.asarray(users, np.int64), device=dev)
        items = torch.arange(self.num_items, device=dev)
        step_users = max(1, SCORE_CELLS // max(1, self.num_items))
        rows = []
        with torch.no_grad(), full_f32():
            for s in range(0, users.shape[0], step_users):
                u = users[s:s + step_users]
                ratings, _ = dmrl_forward(self.params, u, items[None, :].expand(u.shape[0], -1),
                                          None, self._text, self._image, F, fs, 1.0,
                                          per_item=True)
                rows.append(ratings)
        return torch.cat(rows).cpu().numpy()

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        row = self._score_users([user_idx])[0]
        return row if item_idx is None else float(row[item_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._score_users(np.where(known, users, 0)).astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
