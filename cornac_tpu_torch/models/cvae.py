"""CVAE — Collaborative Variational Autoencoder (Li & She, KDD 2017), and
CDR — Collaborative Deep Ranking (Ying et al., PAKDD 2016).

Port of ``cornac_tpu/models/cvae.py``:

- CVAE: an item-content VAE whose latent mean regularises the item
  factors; each epoch solves (U, V) by confidence-weighted ALS on the
  model's device (batched k x k solves over the padded layout ``padded``:
  rows x the largest degree x k), then takes Adam steps on the VAE over the
  items in the order ``rng.permutation`` draws from the fit's numpy
  generator (the JAX package's order), each step's reparameterisation noise
  handed to the step as an argument.
- CDR: CDL's denoising autoencoder coupled with a pairwise ranking loss
  0.5 (1 - u.(v_i - v_j))^2 over sampled (user, positive, negative)
  triplets, observed negatives masked out (``ops.membership``). Each
  epoch's draws come from one ``torch.Generator`` seeded from (the fit's
  seed, the global epoch index): the positives, the negatives, then each
  step's Bernoulli keep mask of the corruption, which the loss takes as an
  argument. The gradients of the factor gathers sum through
  ``accumulate_rows``; nothing syncs with the host inside an epoch.

``mesh`` (``parallel.make_mesh``), as in the JAX package: CVAE's ALS rows
are split over "data" (``weighted_als(mesh=)``: each row is its own k x k
solve, so the slices give the plain solves' bits), and its VAE steps are
data-parallel over "data", the minibatch rounded down to a multiple of the
data axis: every rank draws the whole minibatch's noise, takes its data
slice's terms (the weights' penalty on the first rank of the slice's
group) and ``ops.optim.step`` sums the gradients over "data". CDR's
pairwise minibatches, rounded down to a multiple of the mesh's size, are
split over every rank (``parallel.sharded.Share``): each rank takes its
rows of the whole minibatch's draws (keep masks drawn for the whole
minibatch), the penalty on the weights on rank 0, and the gradients are
summed over every rank. The sums over the ranks take another order than
one device's backward, so the autograd phases agree with the plain fit to
float32 rounding, and bit for bit on a mesh of one rank.
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS
from ..ops.accumulate import gather_rows
from ..ops.membership import build_membership
from ..ops.optim import adam, step
from ..parallel.mesh import DATA_AXIS, check_mesh
from ..parallel.sharded import (
    Share,
    all_sum,
    batch_slice,
    data_group_first,
    data_parallel,
    round_batch,
)
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import xavier_uniform
from .cdl import (
    _FactorScores,
    dense_arrays,
    keep_mask_draws,
    minmax_text,
    mlp_arrays,
    require_text,
    run_mlp,
    weight_norm,
)
from .recommender import Recommender


def padded(mat, pad_len, device):
    """The rows of the CSR ``mat`` padded to ``pad_len`` entries:
    (indices int64, values float32, mask float32), each (rows, pad_len), on
    ``device``."""
    n = mat.shape[0]
    counts = np.diff(mat.indptr)
    idx = np.zeros((n, pad_len), np.int64)
    val = np.zeros((n, pad_len), np.float32)
    mask = np.arange(pad_len)[None, :] < counts[:, None]
    idx[mask] = mat.indices
    val[mask] = mat.data
    return tuple(torch.as_tensor(a, device=device) for a in (idx, val, mask.astype(np.float32)))


def padded_layouts(csr, device):
    """``padded`` of the users' rows and of the items' rows, each to its
    largest degree (at least 1)."""
    csc = csr.T.tocsr()
    return tuple(padded(m, max(1, int(np.diff(m.indptr).max(initial=1))), device)
                 for m in (csr, csc))


def weighted_als(other, pad, a, b, lam, prior=None, mesh=None):
    """One side of confidence-weighted ALS: each row's k x k system
    ``b G + (a - b) sum_j v_j v_j^T + lam I`` (G = other^T other, the sum
    over the row's observed entries) against ``a sum_j r_j v_j`` (+ ``lam
    prior``), solved in one batched LU (``solve_ex``: no sync). ``mesh``:
    the rows are split over "data" and gathered back (``data_parallel``)."""
    k = other.shape[1]
    G = other.T @ other
    eye = torch.eye(k, device=other.device)[None]

    def solve(pad_idx, pad_val, pad_mask, *prior_rows):
        Os = other[pad_idx] * pad_mask[:, :, None]
        A = b * G[None] + (a - b) * torch.einsum("blk,blm->bkm", Os, Os)
        A = A + lam * eye
        rhs = a * torch.einsum("blk,bl->bk", Os, pad_val * pad_mask)
        if prior_rows:
            rhs = rhs + lam * prior_rows[0]
        return torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]

    rows = tuple(pad) + (() if prior is None else (prior,))
    return data_parallel(mesh, solve, pad[0].shape[0], *rows)


def host_order(ids, device):
    """``ids`` (numpy) on ``device``, copied from pinned memory without
    waiting."""
    host = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64))
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def vae_encode(vae, x, act):
    h = run_mlp(vae, "enc", x, act)
    return (h @ vae["mu.w"] + vae["mu.b"], h @ vae["logvar.w"] + vae["logvar.b"])


def cvae_loss(vae, x, v_target, noise, act, loss_type, lambdas, penalised=True):
    """The JAX package's VAE loss on the items' texts ``x`` with the item
    factors ``v_target``: the generation loss (rmse on the sigmoid or
    cross-entropy on the logits), the KL term, the coupling
    lambda_v / lambda_r / 2 |v - mu|^2 and lambda_w |W|^2 over the encoder
    and decoder (left out where ``penalised`` is false: a rank's share of
    a minibatch other than the first); ``noise`` the reparameterisation's
    standard normals."""
    lam_v, lam_r, lam_w = lambdas
    mu, logvar = vae_encode(vae, x, act)
    z = mu + torch.exp(0.5 * logvar) * noise
    logits = run_mlp(vae, "dec", z, act, last_act=False)
    if loss_type == "rmse":
        gen = 0.5 * ((torch.sigmoid(logits) - x) ** 2).sum()
    else:
        gen = (torch.clamp_min(logits, 0) - logits * x
               + torch.log1p(torch.exp(-logits.abs()))).sum()
    latent = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum()
    couple = lam_v / lam_r * 0.5 * ((v_target - mu) ** 2).sum()
    loss = gen + latent + couple
    return loss + lam_w * weight_norm(vae, ("enc", "dec")) if penalised else loss


class CVAE(_FactorScores):
    """Item-content VAE coupled with confidence-weighted MF.

    Parameters mirror the JAX package: ``z_dim``, ``n_epochs``,
    ``lambda_u``, ``lambda_v``, ``lambda_r``, ``lambda_w``, ``lr``, ``a``,
    ``b``, ``input_dim``, ``vae_layers``, ``act_fn``, ``loss_type`` ('rmse'
    or 'cross-entropy'), ``batch_size``, ``init_params`` ({'U', 'V'}),
    ``seed``. ``device``: where the model trains and scores (default: the
    card). ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls
    ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="CVAE",
        z_dim=50,
        n_epochs=100,
        lambda_u=1e-4,
        lambda_v=0.001,
        lambda_r=10,
        lambda_w=1e-4,
        lr=0.001,
        a=1,
        b=0.01,
        input_dim=8000,
        vae_layers=(200, 100),
        act_fn="sigmoid",
        loss_type="cross-entropy",
        batch_size=128,
        init_params=None,
        trainable=True,
        seed=None,
        verbose=True,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.z_dim = z_dim
        self.n_epochs = n_epochs
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_r = lambda_r
        self.lambda_w = lambda_w
        self.lr = lr
        self.a = a
        self.b = b
        self.input_dim = input_dim
        self.vae_layers = list(vae_layers)
        self.act_fn = act_fn
        self.loss_type = loss_type
        self.batch_size = batch_size
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.seed = seed
        if loss_type not in ("rmse", "cross-entropy"):
            raise ValueError("Invalid loss type {}".format(loss_type))

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def _initial(self, rng, vocab):
        """The VAE's initial layers from ``rng`` in the JAX package's order:
        the encoder, the mean and log-variance heads, the decoder."""
        last = self.vae_layers[-1]
        return {**mlp_arrays(rng, [vocab] + self.vae_layers, "enc"),
                **dense_arrays(rng, last, self.z_dim, "mu"),
                **dense_arrays(rng, last, self.z_dim, "logvar"),
                **mlp_arrays(rng, [self.z_dim] + self.vae_layers[::-1] + [vocab], "dec")}

    def step(self, vae, opt, opt_state, x, v_target, noise):
        """One Adam step of the VAE on the items' texts ``x``, the factors
        ``v_target`` and the noise ``noise``, ``vae`` updated in place.
        Returns (the new state, the loss). On a mesh the rows are this
        rank's data slice of the minibatch, and the gradients are summed
        over "data"."""
        mesh = self.mesh
        loss = cvae_loss(vae, x, v_target, noise, ACTIVATIONS[self.act_fn], self.loss_type,
                         (self.lambda_v, self.lambda_r, self.lambda_w), data_group_first(mesh))
        return step(vae, opt, opt_state, loss, mesh), loss.detach()

    def epoch(self, vae, opt, opt_state, V, text, pads, order, step_noise):
        """One epoch: (U, V) by ALS (V pulled toward the VAE's latent means
        of the texts), then Adam steps of the VAE over the items in the
        order ``order`` (numpy), tiled to whole minibatches, the noise of
        the step at position s from ``step_noise(s, shape)``. ``vae`` is
        updated in place. Returns (U, V, the new state). On a mesh the ALS
        rows and each minibatch are split over "data" (module docstring)."""
        act, mesh = ACTIVATIONS[self.act_fn], self.mesh
        with torch.no_grad():
            z_mu = vae_encode(vae, text, act)[0]
            U = weighted_als(V, pads[0], self.a, self.b, self.lambda_u, mesh=mesh)
            V = weighted_als(U, pads[1], self.a, self.b, self.lambda_v, prior=z_mu, mesh=mesh)
        bsz = round_batch(mesh, min(self.batch_size, len(order)), DATA_AXIS)
        starts = range(0, len(order), bsz)
        # ids tiled to whole minibatches (stable shapes, as in the JAX
        # package), the epoch's at once
        ids = host_order(np.concatenate([np.resize(order[s: s + bsz], bsz) for s in starts]),
                         V.device)
        rows = slice(None) if mesh is None else slice(*batch_slice(mesh, bsz)[:2])
        for b, s in enumerate(starts):
            idx = ids[b * bsz: (b + 1) * bsz][rows]
            opt_state, _ = self.step(vae, opt, opt_state, text[idx], V[idx],
                                     step_noise(s, (bsz, self.z_dim))[rows])
        return U, V, opt_state

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        require_text(train_set)
        rng = get_rng(self.seed)
        if self.U is None:
            self.U = xavier_uniform((self.num_users, self.z_dim), rng).astype(np.float32)
        if self.V is None:
            self.V = xavier_uniform((self.num_items, self.z_dim), rng).astype(np.float32)
        if not self.trainable:
            return self

        text = train_set.item_text.batch_bow(np.arange(self.num_items)).astype(np.float32)
        text = text / np.maximum(text.max(), 1e-12)
        dev = self._device()
        vae = {n: torch.tensor(a, device=dev, requires_grad=True)
               for n, a in self._initial(rng, text.shape[1]).items()}
        opt = adam(self.lr)
        opt_state = opt.init(vae)
        pads = padded_layouts(train_set.matrix, dev)
        text_d = torch.as_tensor(text, device=dev)
        V = torch.as_tensor(np.asarray(self.V, np.float32), device=dev)
        seed = rng.randint(2**31)
        for epoch in range(self.n_epochs):
            gen = epoch_generator(seed, epoch, dev)
            U, V, opt_state = self.epoch(vae, opt, opt_state, V, text_d, pads,
                                         rng.permutation(self.num_items),
                                         lambda s, shape: torch.randn(shape, generator=gen,
                                                                      device=dev))
            if self.verbose:
                print("Epoch %d/%d done" % (epoch + 1, self.n_epochs))
        if self.n_epochs > 0:
            self.U = U.cpu().numpy()
        self.V = V.cpu().numpy()
        self.vae = {n: p.detach() for n, p in vae.items()}
        return self


def cdr_draws(gen, n, n_total, num_items):
    """An epoch's draws from ``gen``: (positive pair index, negative item),
    ``n_total`` of each, uniform with replacement."""
    pos_idx = torch.randint(n, (n_total,), generator=gen, device=gen.device)
    negs = torch.randint(num_items, (n_total,), generator=gen, device=gen.device)
    return pos_idx, negs


def cdr_loss(p, text, u, i, j, m, keep_mask, act, lambdas, penalised=True):
    """The JAX package's CDR loss on the triplets (u, i, j) with the
    validity weights ``m`` (0 where j is observed for u) and the
    corruption's keep mask ``keep_mask`` (B, vocab); the weights' penalty
    left out where ``penalised`` is false (a rank's share of a minibatch
    other than the first)."""
    lam_u, lam_v, lam_w, lam_n = lambdas
    B = u.shape[0]
    x = text[i]
    z = run_mlp(p, "enc", x * keep_mask, act)
    recon = run_mlp(p, "dec", z, act, last_act=False)
    pu = gather_rows(p["U"], u)
    v = gather_rows(p["V"], torch.cat([i, j]))
    vi, vj = v[:B], v[B:]
    diff = (pu * (vi - vj)).sum(1)
    loss = (0.5 * (((1.0 - diff) ** 2) * m).sum() + 0.5 * lam_u * (pu ** 2).sum()
            + 0.5 * lam_v * ((vi - z) ** 2).sum() + 0.5 * lam_n * ((recon - x) ** 2).sum())
    return loss + 0.5 * lam_w * weight_norm(p, ("enc", "dec")) if penalised else loss


def cdr_epoch(params, opt, opt_state, draws, data, step_draws, batch_size, act, lambdas,
              mesh=None):
    """One epoch of Adam steps on the draws (``cdr_draws``' pair), ``params``
    updated in place. ``data`` = (text, pairs (n, 2), membership);
    ``step_draws(shape)`` gives a step's keep mask. Returns (the new state,
    the summed loss, a device scalar). ``mesh``: each rank takes its share
    of every minibatch (module docstring)."""
    text, pairs, membership = data
    pos_idx, negs = draws
    users, pos = pairs[pos_idx].unbind(1)
    valid = (~membership.query(users, negs)).to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=negs.device)
    share = Share(mesh, batch_size)
    for s in range(0, negs.shape[0], batch_size):
        sl = slice(s, s + batch_size)
        u = users[sl]
        keep = share.take(step_draws((u.shape[0], text.shape[1])))
        loss = cdr_loss(params, text, share.take(u), share.take(pos[sl]), share.take(negs[sl]),
                        share.take(valid[sl]), keep, act, lambdas, share.first)
        opt_state = step(params, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    return opt_state, loss_sum


class CDR(_FactorScores):
    """SDAE + pairwise ranking (CDL's ranking sibling).

    Parameters mirror the JAX package: ``k``, ``autoencoder_structure``,
    ``act_fn``, ``lambda_u``, ``lambda_v``, ``lambda_w``, ``lambda_n``,
    ``corruption_rate``, ``learning_rate``, ``vocab_size``,
    ``dropout_rate`` (unused, as there), ``batch_size``, ``max_iter``,
    ``init_params`` ({'U', 'V'}), ``seed`` (the generator is made here).
    ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``
    (module docstring).
    """

    def __init__(
        self,
        name="CDR",
        k=50,
        autoencoder_structure=None,
        act_fn="relu",
        lambda_u=0.01,
        lambda_v=0.1,
        lambda_w=0.0001,
        lambda_n=5,
        corruption_rate=0.3,
        learning_rate=0.001,
        vocab_size=8000,
        dropout_rate=0.1,
        batch_size=128,
        max_iter=100,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.autoencoder_structure = (
            [200] if autoencoder_structure is None else list(autoencoder_structure))
        self.act_fn = act_fn
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_w = lambda_w
        self.lambda_n = lambda_n
        self.corruption_rate = corruption_rate
        self.learning_rate = learning_rate
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.rng = get_rng(seed)

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def _initial(self, rng, vocab):
        enc = [vocab] + self.autoencoder_structure + [self.k]
        dec = [self.k] + self.autoencoder_structure[::-1] + [vocab]
        return {**mlp_arrays(rng, enc, "enc"), **mlp_arrays(rng, dec, "dec")}

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        require_text(train_set)
        rng = self.rng
        if self.U is None:
            self.U = xavier_uniform((self.num_users, self.k), rng).astype(np.float32)
        if self.V is None:
            self.V = xavier_uniform((self.num_items, self.k), rng).astype(np.float32)
        if not self.trainable:
            return self

        text = minmax_text(train_set, self.num_items)
        dev = self._device()
        params = {"U": self.U, "V": self.V, **self._initial(rng, text.shape[1])}
        params = {n: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for n, a in params.items()}
        rid, cid, _ = train_set.uir_tuple
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        data = (torch.as_tensor(text, device=dev), pairs,
                build_membership(train_set.csr_matrix, device=dev))
        n = len(rid)
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_batches = (n + bsz - 1) // bsz
        num_items = train_set.num_items
        act = ACTIVATIONS[self.act_fn]
        lambdas = (self.lambda_u, self.lambda_v, self.lambda_w, self.lambda_n)
        keep = 1.0 - self.corruption_rate
        opt = adam(self.learning_rate)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                gen = epoch_generator(seed, epoch, dev)
                draws = cdr_draws(gen, n, n_batches * bsz, num_items)
                opt_state, loss_sum = cdr_epoch(params, opt, opt_state, draws, data,
                                                keep_mask_draws(gen, keep), bsz, act, lambdas,
                                                self.mesh)
            return opt_state, loss_sum

        epoch_loop(self, self.max_iter, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Iter %d/%d, loss: %.2f" % (done, self.max_iter,
                                                   float(loss) / n_batches)))

        self.params = {k: p.detach() for k, p in params.items() if k not in ("U", "V")}
        self.U = params["U"].detach().cpu().numpy().astype(np.float64)
        self.V = params["V"].detach().cpu().numpy().astype(np.float64)
        return self
