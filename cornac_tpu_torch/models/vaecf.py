"""VAECF — Variational Autoencoder for Collaborative Filtering
(Liang et al., WWW 2018).

Port of ``cornac_tpu/models/vaecf.py``: a VAE over binarized user rows
(``engine.nn`` layers), the four likelihoods and the KL weight ``beta``,
Adam with optax's rule (``ops.optim.adam``), the loss by autograd on the
model's device.

The data reach each minibatch in one of three modes, chosen by the JAX
package's constants:

- **resident**: the binarized (users, items) matrix, its rows padded to
  whole batches, lives on the device while it takes at most
  ``_RESIDENT_BYTES``; a batch is a slice of it;
- **index-resident**: above that, the coordinates of the positive entries
  (int32 columns and rows) go to the device once while they take at most
  ``_SPARSE_RESIDENT_BYTES``, and each batch densifies on the device by
  setting ones into a zero block (480,000 x 17,700 takes 34 GB dense and
  160 MB as 20M coordinate pairs);
- **streamed**: above both, each batch's window of coordinates is copied
  from the host and densified the same way.

The three give the same bits: a batch's rows are the same in each, and its
noise comes from a ``torch.Generator`` seeded from (the fit's seed, the
global epoch, the batch index), whatever the mode or the host's chunking of
the epochs (the JAX package folds the same two indices into its key).
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS, Tree, init_dense, init_mlp, mlp
from ..exception import ScoreException
from ..ops.optim import adam, step
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog

EPS = 1e-10

# keep the dense interaction matrix on the device when below this budget
_RESIDENT_BYTES = 512 * 1024 * 1024
# above the dense budget, keep the coordinates of the positive entries on
# the device when they fit this one, and densify each batch there
_SPARSE_RESIDENT_BYTES = 4 * 1024 * 1024 * 1024

LIKELIHOODS = ("mult", "bern", "gaus", "pois")


def _init_vae(rng, z_dim, ae_structure):
    """The JAX package's VAE pytree as a module: ``encoder`` (a stack), the
    heads ``enc_mu`` and ``enc_logvar``, ``decoder`` (a stack), drawn in
    that order; ae_structure = [data_dim, h1, ...]."""
    encoder = init_mlp(rng, ae_structure)
    enc_mu = init_dense(rng, ae_structure[-1], z_dim)
    enc_logvar = init_dense(rng, ae_structure[-1], z_dim)
    decoder = init_mlp(rng, [z_dim] + ae_structure[::-1])
    return Tree(encoder=encoder, enc_mu=enc_mu, enc_logvar=enc_logvar, decoder=decoder)


def _encode(vae, x, act):
    h = x
    for layer in vae.encoder:
        h = act(layer(h))
    return vae.enc_mu(h), vae.enc_logvar(h)


def _decode(vae, z, act, likelihood):
    h = mlp(vae.decoder, z, act)
    if likelihood == "mult":
        return torch.softmax(h, dim=1)
    return torch.sigmoid(h)


def _vae_loss(vae, x, noise, act, likelihood, beta):
    """The JAX package's ``_vae_loss`` with its standard-normal draw
    ``noise`` (the shape of the means) given."""
    mu, logvar = _encode(vae, x, act)
    std = torch.exp(0.5 * logvar)
    z = mu + noise * std
    x_ = _decode(vae, z, act, likelihood)

    if likelihood == "mult":
        ll = x * torch.log(x_ + EPS)
    elif likelihood == "bern":
        ll = x * torch.log(x_ + EPS) + (1 - x) * torch.log(1 - x_ + EPS)
    elif likelihood == "gaus":
        ll = -((x - x_) ** 2)
    else:  # pois
        ll = x * torch.log(x_ + EPS) - x_
    ll = torch.sum(ll, dim=1)

    kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=1)
    return torch.mean(beta * kld - ll)


def _densify(cols, rows, b, bsz, data_dim):
    """(bsz, data_dim) float32 block of batch ``b``: ones at the positive
    entries whose global rows and columns are ``rows`` and ``cols``."""
    x = torch.zeros((bsz, data_dim), dtype=torch.float32, device=cols.device)
    x[rows.long() - b * bsz, cols.long()] = 1.0
    return x


def batch_source(r_mat, bsz, device):
    """(mode, fetch) for the fit's minibatches: ``fetch(b)`` gives batch
    b's dense (bsz, items) block on ``device``, and ``mode`` is
    ``"resident"``, ``"index-resident"`` or ``"streamed"`` (see the module's
    docstring)."""
    n_users, data_dim = r_mat.shape
    n_pad = (-n_users) % bsz
    n_batches = (n_users + n_pad) // bsz
    if (n_users + n_pad) * data_dim * 4 <= _RESIDENT_BYTES:
        X = (r_mat > 0).astype(np.float32).toarray()
        X_d = torch.zeros((n_users + n_pad, data_dim), dtype=torch.float32, device=device)
        X_d[:n_users] = torch.as_tensor(X, device=device)
        return "resident", lambda b: X_d[b * bsz:(b + 1) * bsz]

    csr = r_mat.tocsr()
    keep = csr.data > 0
    cols = csr.indices[keep].astype(np.int32)
    rows = np.repeat(np.arange(n_users, dtype=np.int32), np.diff(csr.indptr))[keep]
    counts = np.bincount(rows // bsz, minlength=n_batches)
    starts = np.concatenate(([0], np.cumsum(counts[:-1]))).tolist()
    counts = counts.tolist()
    if 8 * cols.size <= _SPARSE_RESIDENT_BYTES:
        cols_d = torch.as_tensor(cols, device=device)
        rows_d = torch.as_tensor(rows, device=device)

        def fetch(b):
            s, c = starts[b], counts[b]
            return _densify(cols_d[s:s + c], rows_d[s:s + c], b, bsz, data_dim)

        return "index-resident", fetch

    def fetch(b):
        s, c = starts[b], counts[b]
        return _densify(torch.from_numpy(cols[s:s + c]).to(device),
                        torch.from_numpy(rows[s:s + c]).to(device), b, bsz, data_dim)

    return "streamed", fetch


class VAECF(Recommender, ANNMixin):
    """VAE over binarized user rows.

    Parameters mirror the reference: ``k`` latent dim,
    ``autoencoder_structure`` hidden sizes, ``act_fn``, ``likelihood``
    (mult/bern/gaus/pois), ``n_epochs``, ``batch_size``, ``learning_rate``,
    ``beta`` KL weight, ``seed``; ``device`` where it trains and scores
    (default: the card).
    """

    def __init__(
        self,
        name="VAECF",
        k=10,
        autoencoder_structure=None,
        act_fn="tanh",
        likelihood="mult",
        n_epochs=100,
        batch_size=100,
        learning_rate=0.001,
        beta=1.0,
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
        self.mesh = mesh
        self.k = k
        self.autoencoder_structure = (
            [20] if autoencoder_structure is None else autoencoder_structure
        )
        self.act_fn = act_fn
        self.likelihood = likelihood
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.beta = beta
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
        self.r_mat = train_set.matrix
        dev = self._device()

        data_dim = self.r_mat.shape[1]
        if not hasattr(self, "params"):
            self.params = _init_vae(rng, self.k, [data_dim] + self.autoencoder_structure)
        self.params.to(dev)
        params = dict(self.params.named_parameters())

        act = ACTIVATIONS[self.act_fn]
        opt = adam(self.learning_rate)

        n_users = self.r_mat.shape[0]
        bsz = min(self.batch_size, n_users)
        n_batches = -(-n_users // bsz)
        self.data_mode, fetch = batch_source(self.r_mat, bsz, dev)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                # like the JAX program, report the LAST epoch's sum
                loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
                for b in range(n_batches):
                    noise = torch.randn((bsz, self.k), generator=epoch_generator(
                        seed, epoch, dev, b), device=dev)
                    loss = _vae_loss(self.params, fetch(b), noise, act, self.likelihood,
                                     self.beta)
                    opt_state = step(params, opt, opt_state, loss)
                    loss_sum += loss.detach()
            return opt_state, loss_sum

        def report(done, loss_sum):
            print("Epoch %d/%d, loss: %.4f" % (done, self.n_epochs, float(loss_sum) / n_batches))

        epoch_loop(self, self.n_epochs, run_chunk, opt.init(params), on_report=report,
                   resident=params)
        return self

    def _rows(self, users):
        return (self.r_mat[users] > 0).astype(np.float32).toarray()

    @torch.no_grad()
    def _decode_device(self, x_rows):
        act = ACTIVATIONS[self.act_fn]
        mu, _ = _encode(self.params, torch.as_tensor(x_rows, device=self._device()), act)
        return _decode(self.params, mu, act, self.likelihood)

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        scores = self._decode_device(self._rows([user_idx]))[0].cpu().numpy()
        return scores if item_idx is None else scores[item_idx]

    def score_pairs(self, user_indices, item_indices):
        # pointwise score == row gather (no per-pair transform): batch it
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

    def get_vector_measure(self):
        return MEASURE_DOT

    @torch.no_grad()
    def get_user_vectors(self):
        # the whole binarized matrix, dense on the host, as the JAX package
        X = (self.r_mat > 0).astype(np.float32).toarray()
        mu, _ = _encode(self.params, torch.as_tensor(X, device=self._device()),
                        ACTIVATIONS[self.act_fn])
        return mu.cpu().numpy()

    def get_item_vectors(self):
        # the decoder's last weight: (items, h1), as the JAX package's
        return self.params.decoder[-1].w.detach().cpu().numpy().T
