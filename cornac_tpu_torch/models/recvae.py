"""RecVAE (Shenbin et al., WSDM 2020).

Port of ``cornac_tpu/models/recvae.py``: a residual swish/LayerNorm encoder
(``_layernorm`` with eps 0.1, no gain), a linear decoder, the composite
prior (a standard normal, the frozen old posterior ``enc_old``, a wide
normal) and alternating encoder and decoder epochs, each with its own Adam
(optax's rule, ``ops.optim.adam``).

Randomness: each encoder or decoder epoch draws from a ``torch.Generator``
seeded from (the fit's seed, the global epoch, the sub-epoch: ``i`` for the
i-th encoder epoch, ``100 + i`` for the i-th decoder epoch, as the JAX
package folds them into its keys); within it, every minibatch draws its
dropout mask (encoder epochs) and then its noise. The losses take both as
arguments, so the tests hand them the JAX package's draws.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.nn import Tree, init_dense
from ..exception import ScoreException
from ..ops.optim import adam, step
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .recommender import Recommender, pad_to_catalog

LOG2PI = float(np.log(2 * np.pi))
_PRIOR_LOG_WEIGHTS = [float(np.log(w)) for w in (3 / 20, 3 / 4, 1 / 10)]


def _swish(x):
    return x * torch.sigmoid(x)


def _layernorm(x, eps=1e-1):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps)


def _log_norm_pdf(x, mu, logvar):
    return -0.5 * (logvar + LOG2PI + (x - mu) ** 2 / torch.exp(logvar))


def _init_encoder(rng, input_dim, hidden, latent):
    """``fc`` (five layers), the heads ``mu`` and ``logvar``, drawn in that
    order."""
    fc = [init_dense(rng, input_dim, hidden)] + [init_dense(rng, hidden, hidden)
                                                 for _ in range(4)]
    return Tree(fc=nn.ModuleList(fc), mu=init_dense(rng, hidden, latent),
                logvar=init_dense(rng, hidden, latent))


def _encode_ref(enc, x, dropout_rate, keep=None):
    """The JAX package's residual wiring: h_k = LN(swish(fc_k(h_{k-1}) +
    h_1 + ... + h_{k-1})). ``keep``: the bool dropout mask of x's shape,
    drawn with keep probability 1 - dropout_rate (used when
    dropout_rate > 0)."""
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
    if dropout_rate > 0:
        x = torch.where(keep, x / (1.0 - dropout_rate), 0.0)

    h1 = _layernorm(_swish(enc.fc[0](x)))
    acc = h1
    prev = h1
    for layer in enc.fc[1:]:
        prev = _layernorm(_swish(layer(prev) + acc))
        acc = acc + prev
    return enc.mu(prev), enc.logvar(prev)


def _recvae_loss(enc, dec, enc_old, x, keep, noise, dropout_rate, gamma, beta):
    """The JAX package's ``RecVAE._loss``, with the dropout mask ``keep``
    and the standard-normal draw ``noise`` (the shape of the means) given."""
    mu, logvar = _encode_ref(enc, x, dropout_rate, keep)
    std = torch.exp(0.5 * logvar)
    z = mu + 0.01 * noise * std
    x_pred = dec(z)

    kl_weight = gamma * x.sum(dim=-1) if gamma else beta

    mll = torch.mean(torch.sum(F.log_softmax(x_pred, dim=-1) * x, dim=-1))

    # composite prior: N(0,1), old posterior, N(0, e^10)
    post_mu, post_logvar = _encode_ref(enc_old, x, 0.0)
    stnd = _log_norm_pdf(z, 0.0, torch.zeros_like(z))
    post = _log_norm_pdf(z, post_mu, post_logvar)
    unif = _log_norm_pdf(z, 0.0, torch.full_like(z, 10.0))
    w = _PRIOR_LOG_WEIGHTS
    prior = torch.logsumexp(torch.stack([stnd + w[0], post + w[1], unif + w[2]], dim=-1), dim=-1)
    kld = torch.mean(torch.sum(_log_norm_pdf(z, mu, logvar) - prior, dim=-1) * kl_weight)
    return -(mll - kld)


def _frozen(enc):
    """A copy of ``enc`` that no gradient reaches (the prior's old
    posterior)."""
    old = copy.deepcopy(enc)
    old.requires_grad_(False)
    return old


class RecVAE(Recommender):
    """VAE with composite prior and alternating optimization."""

    def __init__(
        self,
        name="RecVae",
        hidden_dim=600,
        latent_dim=200,
        batch_size=100,
        beta=None,
        gamma=0.005,
        lr=5e-4,
        n_epochs=100,
        n_enc_epochs=3,
        n_dec_epochs=1,
        not_alternating=False,
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
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.batch_size = batch_size
        self.beta = beta
        self.gamma = gamma
        self.lr = lr
        self.n_epochs = n_epochs
        self.n_enc_epochs = n_enc_epochs
        self.n_dec_epochs = n_dec_epochs
        self.not_alternating = not_alternating
        self.seed = seed
        self.use_gpu = use_gpu  # API parity; the device is ``device``
        self.device = device

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        dev = self._device()
        input_dim = train_set.num_items
        self.enc = _init_encoder(rng, input_dim, self.hidden_dim, self.latent_dim).to(dev)
        self.dec = init_dense(rng, self.latent_dim, input_dim).to(dev)
        enc_old = _frozen(self.enc)

        X = (train_set.matrix > 0).astype(np.float32).toarray()
        n_users = X.shape[0]
        bsz = min(self.batch_size, n_users)
        n_batches = -(-n_users // bsz)
        X_d = torch.zeros((n_batches * bsz, input_dim), dtype=torch.float32, device=dev)
        X_d[:n_users] = torch.as_tensor(X, device=dev)

        enc_params = dict(self.enc.named_parameters())
        dec_params = dict(self.dec.named_parameters())
        opt_enc, opt_dec = adam(self.lr), adam(self.lr)
        enc_state, dec_state = opt_enc.init(enc_params), opt_dec.init(dec_params)
        gamma, beta = self.gamma, self.beta

        def enc_epoch(state, enc_old, gen, dropout_rate):
            for b in range(n_batches):
                x = X_d[b * bsz:(b + 1) * bsz]
                keep = torch.rand(x.shape, generator=gen, device=dev) < 1.0 - dropout_rate
                noise = torch.randn((bsz, self.latent_dim), generator=gen, device=dev)
                loss = _recvae_loss(self.enc, self.dec, enc_old, x, keep, noise, dropout_rate,
                                    gamma, beta)
                state = step(enc_params, opt_enc, state, loss)
            return state

        def dec_epoch(state, enc_old, gen):
            for b in range(n_batches):
                x = X_d[b * bsz:(b + 1) * bsz]
                noise = torch.randn((bsz, self.latent_dim), generator=gen, device=dev)
                loss = _recvae_loss(self.enc, self.dec, enc_old, x, None, noise, 0.0, gamma,
                                    beta)
                state = step(dec_params, opt_dec, state, loss)
            return state

        seed = rng.randint(2**31)
        for epoch in range(self.n_epochs):
            if self.not_alternating:
                enc_state = enc_epoch(enc_state, enc_old, epoch_generator(seed, epoch, dev, 0),
                                      0.5)
                dec_state = dec_epoch(dec_state, enc_old, epoch_generator(seed, epoch, dev, 100))
            else:
                for i in range(self.n_enc_epochs):
                    enc_state = enc_epoch(enc_state, enc_old,
                                          epoch_generator(seed, epoch, dev, i), 0.5)
                enc_old = _frozen(self.enc)  # update prior
                for i in range(self.n_dec_epochs):
                    dec_state = dec_epoch(dec_state, enc_old,
                                          epoch_generator(seed, epoch, dev, 100 + i))
            if self.verbose:
                print("Epoch %d/%d done" % (epoch + 1, self.n_epochs))

        self.r_mat = train_set.matrix
        return self

    @torch.no_grad()
    def _decode_device(self, rows):
        mu, _ = _encode_ref(self.enc, torch.as_tensor(rows, device=self._device()), 0.0)
        return self.dec(mu)

    def _rows(self, users):
        return (self.r_mat[users] > 0).astype(np.float32).toarray()

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        scores = self._decode_device(self._rows([user_idx]))[0].cpu().numpy()
        return scores if item_idx is None else scores[item_idx]

    def score_pairs(self, user_indices, item_indices):
        return self._score_pairs_from_rows(user_indices, item_indices)

    def _known_scores_device(self, safe_users, known):
        return self._decode_device(self._rows(safe_users))

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        rows = self._rows(np.where(known, users, 0))
        scores = self._decode_device(rows).cpu().numpy().astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
