"""BiVAECF — Bilateral Variational Autoencoder (Truong et al., WSDM 2021).

Port of ``cornac_tpu/models/bivaecf.py``: a user VAE over the rows of the
binarized matrix and an item VAE over its columns, trained by alternating
sweeps (the item side, then the user side, every epoch), each side with its
own Adam (optax's rule, ``ops.optim.adam``), with the bern/gaus/pois
likelihoods. As in the JAX package, both sides' rows are padded with zero
rows to whole batches, each step refreshes its batch's rows of the side's
latent table (a sample and the mean) with the updated encoder, and the
padded rows are cut off after the sweep.

Randomness: each sweep draws from a ``torch.Generator`` seeded from (the
fit's seed, the global epoch, the side: 0 items, 1 users), every minibatch
drawing the loss's noise and then the refresh's. The loss takes its noise
as an argument, so the tests hand it the JAX package's draws.

Constrained adaptive priors (``cap_priors={"user": True, "item": True}``):
a side's KL term centres its means on a linear map (``prior``, drawn after
both encoders, user side first) of the entity's features, read from the
train set's ``user_feature`` / ``item_feature`` modality. As in the JAX
package, the map is evaluated outside the differentiated loss, so no step
moves it: it keeps its initial draw (``_trained``). Serving:
``recommend_batch`` ranks ``mu_theta · mu_betaᵀ`` through ``fused_topk``.
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS, Tree, init_dense, init_mlp
from ..exception import ScoreException
from ..ops.dense_scores import device_dot
from ..ops.optim import adam, step
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog

EPS = 1e-10
LIKELIHOODS = ("bern", "gaus", "pois")


def _init_side(rng, sizes, k):
    """One side's encoder: ``enc`` (a stack), the heads ``mu`` and ``std``,
    drawn in that order."""
    enc = init_mlp(rng, sizes)
    return Tree(enc=enc, mu=init_dense(rng, sizes[-1], k), std=init_dense(rng, sizes[-1], k))


def _encode_side(side, x, act):
    h = x
    for layer in side.enc:
        h = act(layer(h))
    return side.mu(h), torch.sigmoid(side.std(h))


def _side_loss(side, x, other_table, noise, act, likelihood, kl_beta, mu_prior=0.0):
    """The JAX package's ``_side_loss`` with its standard-normal draw
    ``noise`` (the shape of the means) given."""
    mu, std = _encode_side(side, x, act)
    z = mu + noise * std
    x_ = torch.sigmoid(z @ other_table.T)

    if likelihood == "bern":
        ll = x * torch.log(x_ + EPS) + (1 - x) * torch.log(1 - x_ + EPS)
    elif likelihood == "gaus":
        ll = -((x - x_) ** 2)
    else:  # pois
        ll = x * torch.log(x_ + EPS) - x_
    ll = torch.sum(ll, dim=1)

    kld = -0.5 * torch.sum(1 + 2.0 * torch.log(std) - (mu - mu_prior) ** 2 - std**2, dim=1)
    return torch.mean(kl_beta * kld - ll)


def _padded(A, bsz, device):
    """(A with zero rows up to a multiple of bsz on ``device``, batches)."""
    n_batches = -(-A.shape[0] // bsz)
    out = torch.zeros((n_batches * bsz, A.shape[1]), dtype=torch.float32, device=device)
    out[:A.shape[0]] = torch.as_tensor(A, device=device)
    return out, n_batches


def _trained(side):
    """The parameters a side's Adam steps: all but the prior map, which the
    JAX package evaluates outside the differentiated loss (its gradient is
    zero there, so Adam leaves it as drawn)."""
    return {n: p for n, p in side.named_parameters() if not n.startswith("prior.")}


def _sweep(side, opt, state, data, n_batches, bsz, n_real, other_table, gen, act, likelihood,
           kl_beta, feats=None):
    """One pass over a side's batches: an Adam step on each, then the
    batch's rows of the latent tables (sample, mean) from the updated
    encoder. ``feats``: the side's feature rows, padded as ``data``, when
    its prior is constrained (its KL centres on ``side.prior(features)``).
    Returns (state, table[:n_real], mu_table[:n_real])."""
    params = _trained(side)
    k = side.mu.b.shape[0]
    table = torch.zeros((n_batches * bsz, k), dtype=torch.float32, device=data.device)
    mu_table = torch.zeros_like(table)
    for b in range(n_batches):
        rows = slice(b * bsz, (b + 1) * bsz)
        x = data[rows]
        noise = torch.randn((bsz, k), generator=gen, device=data.device)
        with torch.no_grad():
            mu_prior = 0.0 if feats is None else side.prior(feats[rows])
        loss = _side_loss(side, x, other_table, noise, act, likelihood, kl_beta, mu_prior)
        state = step(params, opt, state, loss)
        with torch.no_grad():
            mu, std = _encode_side(side, x, act)
            table[rows] = mu + torch.randn((bsz, k), generator=gen, device=data.device) * std
            mu_table[rows] = mu
    return state, table[:n_real], mu_table[:n_real]


class BiVAECF(Recommender, ANNMixin):
    """Dual VAEs over user rows and item columns with shared latent dim."""

    def __init__(
        self,
        name="BiVAECF",
        k=10,
        encoder_structure=None,
        act_fn="tanh",
        likelihood="pois",
        n_epochs=100,
        batch_size=100,
        learning_rate=0.001,
        beta_kl=1.0,
        cap_priors=None,
        trainable=True,
        verbose=False,
        seed=None,
        use_gpu=True,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
        self.k = k
        self.encoder_structure = [20] if encoder_structure is None else list(encoder_structure)
        self.act_fn = act_fn
        self.likelihood = likelihood
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.beta_kl = beta_kl
        self.cap_priors = {"user": False, "item": False} if cap_priors is None else cap_priors
        self.seed = seed
        self.use_gpu = use_gpu  # API parity; the device is ``device``
        self.device = device

        if self.likelihood not in LIKELIHOODS:
            raise ValueError("Supported likelihoods: {}".format(LIKELIHOODS))
        if self.act_fn not in ACTIVATIONS:
            raise ValueError("Supported act_fn: {}".format(list(ACTIVATIONS)))

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        dev = self._device()
        n_users, n_items = train_set.num_users, train_set.num_items
        act = ACTIVATIONS[self.act_fn]

        user_side = _init_side(rng, [n_items] + self.encoder_structure, self.k)
        item_side = _init_side(rng, [n_users] + self.encoder_structure, self.k)
        feats = {}
        for name, side, modality, rows in (
                ("user", user_side, "user_feature", n_users),
                ("item", item_side, "item_feature", n_items)):
            if self.cap_priors.get(name, False):
                F = np.asarray(getattr(train_set, modality).features[:rows], dtype=np.float32)
                side.add_module("prior", init_dense(rng, F.shape[1], self.k))
                feats[name] = F
        user_side, item_side = user_side.to(dev), item_side.to(dev)
        theta = torch.as_tensor(rng.normal(0, 0.01, (n_users, self.k)).astype(np.float32),
                                device=dev)
        beta = torch.as_tensor(rng.normal(0, 0.01, (n_items, self.k)).astype(np.float32),
                               device=dev)

        X = (train_set.matrix > 0).astype(np.float32).toarray()
        bsz_u, bsz_i = min(self.batch_size, n_users), min(self.batch_size, n_items)
        X_d, nb_u = _padded(X, bsz_u, dev)
        XT_d, nb_i = _padded(np.ascontiguousarray(X.T), bsz_i, dev)
        uf_d = _padded(feats["user"], bsz_u, dev)[0] if "user" in feats else None
        if_d = _padded(feats["item"], bsz_i, dev)[0] if "item" in feats else None

        opt_u, opt_i = adam(self.learning_rate), adam(self.learning_rate)
        state_u = opt_u.init(_trained(user_side))
        state_i = opt_i.init(_trained(item_side))
        common = (act, self.likelihood, self.beta_kl)

        seed = rng.randint(2**31)
        mu_theta, mu_beta = torch.zeros_like(theta), torch.zeros_like(beta)
        for epoch in range(self.n_epochs):
            state_i, beta, mu_beta = _sweep(item_side, opt_i, state_i, XT_d, nb_i, bsz_i,
                                            n_items, theta, epoch_generator(seed, epoch, dev, 0),
                                            *common, if_d)
            state_u, theta, mu_theta = _sweep(user_side, opt_u, state_u, X_d, nb_u, bsz_u,
                                              n_users, beta, epoch_generator(seed, epoch, dev, 1),
                                              *common, uf_d)
            if self.verbose:
                print("Epoch %d/%d done" % (epoch + 1, self.n_epochs))

        self.user_side, self.item_side = user_side, item_side
        self.mu_theta = mu_theta.cpu().numpy().astype(np.float64)
        self.mu_beta = mu_beta.cpu().numpy().astype(np.float64)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        from scipy.special import expit

        if item_idx is None:
            return expit(self.mu_beta @ self.mu_theta[user_idx])
        # pointwise predictions are scaled from the decoder's [0, 1] range
        # to the rating range (reference recom_bivaecf.py:225)
        pred = float(expit(self.mu_beta[item_idx] @ self.mu_theta[user_idx]))
        return self.min_rating + pred * (self.max_rating - self.min_rating)

    def score_pairs(self, user_indices, item_indices):
        # pointwise predictions are row values scaled to the rating range
        # (reference recom_bivaecf.py:225)
        span = self.max_rating - self.min_rating
        return self._score_pairs_from_rows(
            user_indices, item_indices, transform=lambda s: self.min_rating + s * span)

    def _known_scores_device(self, safe_users, known):
        return torch.sigmoid(device_dot(self.mu_theta[safe_users], self.mu_beta,
                                        self._device()))

    def score_batch(self, user_indices):
        from scipy.special import expit

        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = expit(self.mu_theta[np.where(known, users, 0)] @ self.mu_beta.T)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.mu_theta

    def get_item_vectors(self):
        return self.mu_beta
