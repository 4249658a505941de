"""CVAECF — Conditional VAE for Collaborative Filtering (Lee et al.,
augmenting VAEs with social context).

Port of ``cornac_tpu/models/cvaecf.py``: a dual-latent conditional VAE. The
preference latent z is inferred from the user's binarized interaction row
y (q(z|y)), the auxiliary latent h from the user's row x of the social
adjacency ``train_set.user_graph.matrix`` (q(h|x)), regularized toward a
conditional prior p(h|x) and a preference-side posterior q(h|y); the
decoder reconstructs y from [z, h]. The loss weights follow the JAX
package's documented semantics: ``beta`` KL(z), ``alpha_1``
KL(q(h|x) || p(h|x)), ``alpha_2`` KL(q(h|x) || q(h|y)).

The networks are ``engine.nn`` layers drawn from the same numpy stream as
the JAX package's; Adam follows optax's rule (``ops.optim.adam``); the
rating and social rows, padded to whole batches, live on the device. Each
batch's reparameterisation noise comes from a ``torch.Generator`` seeded
from (the fit's seed, the global epoch, the batch), where the JAX package
folds the same indices into its key, so chunking and a resume from a
checkpoint (``epoch_loop``) draw what an uninterrupted fit draws.
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS, Tree, init_dense, init_mlp, mlp
from ..exception import ScoreException
from ..ops.optim import adam, step
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from .recommender import Recommender

EPS = 1e-10

LIKELIHOODS = ("mult", "bern", "gaus", "pois")


def _init_branch(rng, sizes, out_dim):
    """Encoder trunk (a stack over ``sizes``) and its mu/logvar heads."""
    return Tree(trunk=init_mlp(rng, sizes), mu=init_dense(rng, sizes[-1], out_dim),
                logvar=init_dense(rng, sizes[-1], out_dim))


def _branch(branch, x, act):
    h = x
    for layer in branch.trunk:
        h = act(layer(h))
    return branch.mu(h), branch.logvar(h)


def _init_cvae(rng, z_dim, h_dim, sizes_y, sizes_x):
    """q(z|y), q(h|x), q(h|y), p(h|x) and the decoder, in the JAX
    package's order."""
    qz = _init_branch(rng, sizes_y, z_dim)
    qhx = _init_branch(rng, sizes_x, h_dim)
    qhy = _init_branch(rng, sizes_y, h_dim)
    phx = _init_branch(rng, sizes_x, h_dim)
    decoder = init_mlp(rng, [z_dim + h_dim] + sizes_y[::-1])
    return Tree(qz=qz, qhx=qhx, qhy=qhy, phx=phx, decoder=decoder)


def _decode(params, z, h, act, likelihood):
    out = mlp(params.decoder, torch.cat([z, h], dim=1), act)
    if likelihood == "mult":
        return torch.softmax(out, dim=1)
    return torch.sigmoid(out)


def _cvae_loss(params, y, x, noise_z, noise_h, act, likelihood, beta, alpha_1, alpha_2):
    """The JAX package's ``_cvae_loss`` with its two standard-normal draws
    (the shapes of the z and h means) given."""
    mu_qz, logvar_qz = _branch(params.qz, y, act)
    mu_qhx, logvar_qhx = _branch(params.qhx, x, act)
    mu_qhy, logvar_qhy = _branch(params.qhy, y, act)
    mu_ph, _ = _branch(params.phx, x, act)

    z = mu_qz + noise_z * torch.exp(0.5 * logvar_qz)
    h = mu_qhx + noise_h * torch.exp(0.5 * logvar_qhx)
    y_ = _decode(params, z, h, act, likelihood)

    if likelihood == "mult":
        ll = y * torch.log(y_ + EPS)
    elif likelihood == "bern":
        ll = y * torch.log(y_ + EPS) + (1 - y) * torch.log(1 - y_ + EPS)
    elif likelihood == "gaus":
        ll = -((y - y_) ** 2)
    else:  # pois
        ll = y * torch.log(y_ + EPS) - y_
    ll = torch.sum(ll, dim=1)

    kld_z = -0.5 * torch.sum(1 + logvar_qz - mu_qz**2 - torch.exp(logvar_qz), dim=1)
    # KL(q(h|x) || p(h|x)) with unit prior variance
    kld_hx = -0.5 * torch.sum(
        1 + logvar_qhx - (mu_qhx - mu_ph) ** 2 - torch.exp(logvar_qhx), dim=1)
    # KL(q(h|x) || q(h|y))
    kld_hy = -0.5 * torch.sum(
        1 + logvar_qhx - logvar_qhy
        - ((mu_qhx - mu_qhy) ** 2 + torch.exp(logvar_qhx)) / torch.exp(logvar_qhy),
        dim=1,
    )
    return torch.mean(beta * kld_z + alpha_1 * kld_hx + alpha_2 * kld_hy - ll)


class CVAECF(Recommender):
    """Conditional VAE over preference rows with a social-graph latent.

    Needs a ``user_graph`` modality on the eval method; its rows
    ``user_graph.matrix`` are the conditioning signal. ``device``: where it
    trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="CVAECF",
        z_dim=20,
        h_dim=20,
        autoencoder_structure=None,
        act_fn="tanh",
        likelihood="mult",
        n_epochs=100,
        batch_size=128,
        learning_rate=0.001,
        beta=1.0,
        alpha_1=1.0,
        alpha_2=1.0,
        trainable=True,
        verbose=False,
        seed=None,
        use_gpu=False,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.z_dim = z_dim
        self.h_dim = h_dim
        self.autoencoder_structure = (
            [20] if autoencoder_structure is None else autoencoder_structure
        )
        self.act_fn = act_fn
        self.likelihood = likelihood
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.beta = beta
        self.alpha_1 = alpha_1
        self.alpha_2 = alpha_2
        self.seed = seed
        self.mesh = mesh
        self.use_gpu = use_gpu  # API parity; the device is ``device``
        self.device = device

        if self.likelihood not in LIKELIHOODS:
            raise ValueError("Supported likelihoods: {}".format(LIKELIHOODS))
        if self.act_fn not in ACTIVATIONS:
            raise ValueError("Supported act_fn: {}".format(list(ACTIVATIONS)))

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        if train_set.user_graph is None:
            raise ValueError("CVAECF requires a user_graph modality")

        self.r_mat = train_set.matrix
        # the social adjacency restricted to train users
        adj = train_set.user_graph.matrix
        n_users = self.r_mat.shape[0]
        self.u_adj_mat = adj[:n_users, :n_users]

        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        dev = self._device()
        n_items = self.r_mat.shape[1]
        if not hasattr(self, "params"):
            self.params = _init_cvae(rng, self.z_dim, self.h_dim,
                                     [n_items] + self.autoencoder_structure,
                                     [n_users] + self.autoencoder_structure)
        self.params.to(dev)
        params = dict(self.params.named_parameters())

        act = ACTIVATIONS[self.act_fn]
        opt = adam(self.learning_rate)

        bsz = min(self.batch_size, n_users)
        n_pad = (-n_users) % bsz
        n_batches = (n_users + n_pad) // bsz
        Y = torch.zeros((n_users + n_pad, n_items), dtype=torch.float32, device=dev)
        Y[:n_users] = torch.as_tensor((self.r_mat > 0).astype(np.float32).toarray(), device=dev)
        X = torch.zeros((n_users + n_pad, n_users), dtype=torch.float32, device=dev)
        X[:n_users] = torch.as_tensor(np.asarray(self.u_adj_mat.todense(), np.float32),
                                      device=dev)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                # like the JAX program, report the LAST epoch's sum
                loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
                for b in range(n_batches):
                    gen = epoch_generator(seed, epoch, dev, b)
                    noise_z = torch.randn((bsz, self.z_dim), generator=gen, device=dev)
                    noise_h = torch.randn((bsz, self.h_dim), generator=gen, device=dev)
                    rows = slice(b * bsz, (b + 1) * bsz)
                    loss = _cvae_loss(self.params, Y[rows], X[rows], noise_z, noise_h, act,
                                      self.likelihood, self.beta, self.alpha_1, self.alpha_2)
                    opt_state = step(params, opt, opt_state, loss)
                    loss_sum += loss.detach()
            return opt_state, loss_sum

        def report(done, loss_sum):
            print("Epoch %d/%d, loss: %.4f" % (done, self.n_epochs, float(loss_sum) / n_batches))

        epoch_loop(self, self.n_epochs, run_chunk, opt.init(params), on_report=report,
                   resident=params)
        return self

    @torch.no_grad()
    def _decode_users(self, y_rows, x_rows):
        act = ACTIVATIONS[self.act_fn]
        dev = self.params.decoder[0].w.device
        mu_z, _ = _branch(self.params.qz, torch.as_tensor(y_rows, device=dev), act)
        mu_h, _ = _branch(self.params.qhx, torch.as_tensor(x_rows, device=dev), act)
        return _decode(self.params, mu_z, mu_h, act, self.likelihood).cpu().numpy()

    def _user_rows(self, users):
        y = (self.r_mat[users] > 0).astype(np.float32).toarray()
        x = (self.u_adj_mat[users] > 0).astype(np.float32).toarray()
        return y, x

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        y, x = self._user_rows([user_idx])
        scores = self._decode_users(y, x)[0]
        return scores if item_idx is None else scores[item_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        y, x = self._user_rows(np.where(known, users, 0))
        scores = self._decode_users(y, x).astype(np.float64)
        scores[~known] = self.default_score()
        total = self.total_items
        if scores.shape[1] < total:
            out = np.broadcast_to(
                scores.min(axis=1, keepdims=True), (scores.shape[0], total)
            ).copy()
            out[:, : scores.shape[1]] = scores
            return out
        return scores
