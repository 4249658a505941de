"""CDL — Collaborative Deep Learning (Wang, Wang & Yeung, KDD 2015).

Port of ``cornac_tpu/models/cdl.py``: a stacked denoising autoencoder over
the items' bags of words coupled with confidence-weighted matrix
factorisation; each minibatch of items takes two Adam steps (optax's rule,
``ops.optim.adam``), one on (U, V) with the autoencoder fixed, then one on
the autoencoder at the new (U, V).

The item texts (min-max normalised), the rating matrix R and the
confidences C (``a`` where R is non-zero, else ``b``) stay on the model's
device for the whole fit, R and C as (items, users) rows, so a minibatch's
columns are a gather of rows. Each epoch takes its draws from one
``torch.Generator`` seeded from (the fit's seed, the global epoch index):
the order (a permutation of the items rounded up to whole minibatches,
modulo their number), then each step's Bernoulli keep mask of the
corruption, which the loss takes as an argument, so a test can hand it
the JAX key's own. The gradient of the item-factor gather sums through
``accumulate_rows``. Nothing syncs with the host inside an epoch.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank, as
the JAX package shards each item minibatch over all mesh axes: the
minibatch is rounded down to a multiple of the mesh's size, every rank
draws the whole minibatch's keep mask and takes its rows
(``parallel.sharded.Share``), the terms of no row (U's penalty, the
weights') on rank 0, and both steps' gradients are summed over every rank
(``parallel.sharded.sum_grads``). The sums take another order than one
device's backward, so the fit agrees with the plain fit to float32
rounding, and bit for bit on a mesh of one rank.
"""

import numpy as np
import torch

from ..engine.nn import ACTIVATIONS
from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot
from ..ops.optim import adam, apply_updates
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch, sum_grads
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from ..utils.init_utils import xavier_uniform
from .mf import _epoch_permutation
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def mlp_arrays(rng, sizes, prefix):
    """A stack of layers ``sizes`` = [in, h1, ...] as a flat dict of
    float32 arrays {f"{prefix}.{j}.w", f"{prefix}.{j}.b"}, each layer's w
    then b drawn from ``rng`` uniform in +-1/sqrt(fan_in), as the JAX
    package's ``init_mlp`` draws them."""
    out = {}
    for j in range(len(sizes) - 1):
        out.update(dense_arrays(rng, sizes[j], sizes[j + 1], f"{prefix}.{j}"))
    return out


def dense_arrays(rng, fan_in, fan_out, name):
    """One layer as the JAX package's ``init_dense`` draws it."""
    bound = 1.0 / np.sqrt(fan_in)
    w = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, size=(fan_out,)).astype(np.float32)
    return {name + ".w": w, name + ".b": b}


def layer_names(params, prefix):
    """The layer names ``prefix.0``, ``prefix.1``, ... present in
    ``params``, in order."""
    names = []
    while f"{prefix}.{len(names)}.w" in params:
        names.append(f"{prefix}.{len(names)}")
    return names


def run_mlp(params, prefix, x, act, last_act=True):
    """The stack ``prefix`` on ``x``: ``act`` after every layer, or after
    every layer but the last when ``last_act`` is false."""
    names = layer_names(params, prefix)
    for j, name in enumerate(names):
        x = x @ params[name + ".w"] + params[name + ".b"]
        if last_act or j < len(names) - 1:
            x = act(x)
    return x


def weight_norm(params, prefixes):
    """The sum of the squared weights (not the biases) of the stacks
    ``prefixes``."""
    total = 0.0
    for prefix in prefixes:
        for name in layer_names(params, prefix):
            total = total + (params[name + ".w"] ** 2).sum()
    return total


def dense_rows(train_set, device, by="user"):
    """The train rating matrix, dense float32 on ``device``: (users, items)
    ``by`` user, (items, users) ``by`` item; built there from the ratings,
    not densified on the host."""
    uid, iid, val = train_set.uir_tuple
    rows, cols = (uid, iid) if by == "user" else (iid, uid)
    shape = ((train_set.num_users, train_set.num_items) if by == "user"
             else (train_set.num_items, train_set.num_users))
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    out[torch.as_tensor(np.asarray(rows, np.int64), device=device),
        torch.as_tensor(np.asarray(cols, np.int64), device=device)] = torch.as_tensor(
        np.asarray(val, np.float32), device=device)
    return out


def minmax_text(train_set, num_items):
    """The items' bags of words as float32, min-max normalised over the
    whole matrix, as CDL and CDR normalise them."""
    text = train_set.item_text.batch_bow(np.arange(num_items)).astype(np.float32)
    return (text - text.min()) / max(text.max() - text.min(), 1e-12)


def require_text(train_set):
    if train_set.item_text is None:
        raise ValueError("this model needs the item_text modality attached to the eval method")


def cdl_loss(params, sdae, ids, x_corrupt, x_clean, R_rows, C_rows, act, lambdas,
             penalised=True):
    """The JAX package's ``loss_fn`` for the minibatch of items ``ids``:
    0.5 sum C (R - U V_b^T)^2 + lambda_u/2 |U|^2 + lambda_v/2 |V_b - z|^2 +
    lambda_n/2 |recon - x|^2 + lambda_w/2 sum |W|^2, where z encodes the
    corrupted text and recon decodes z. ``params`` holds U and V, ``sdae``
    the autoencoder; ``R_rows``, ``C_rows`` (B, users). The terms of no
    row (U's and the weights' penalties) are left out where ``penalised``
    is false (a rank's share of a minibatch other than the first)."""
    lam_u, lam_v, lam_w, lam_n = lambdas
    U, Vb = params["U"], gather_rows(params["V"], ids)
    z = run_mlp(sdae, "enc", x_corrupt, act)
    recon = run_mlp(sdae, "dec", z, act, last_act=False)
    pred = Vb @ U.T  # (B, users)
    cf = 0.5 * (C_rows * (R_rows - pred) ** 2).sum()
    coupled = 0.5 * lam_v * ((Vb - z) ** 2).sum()
    recon_loss = 0.5 * lam_n * ((recon - x_clean) ** 2).sum()
    if not penalised:
        return cf + coupled + recon_loss
    return (cf + 0.5 * lam_u * (U ** 2).sum() + coupled + recon_loss
            + 0.5 * lam_w * weight_norm(sdae, ("enc", "dec")))


def cdl_epoch(params, sdae, opts, states, order, data, step_draws, batch_size, act, lambdas,
              mesh=None):
    """One epoch over the items in the order ``order`` ((n_total,) int64):
    each minibatch's Adam step on (U, V) with the autoencoder fixed, then
    on the autoencoder at the new (U, V), ``params`` and ``sdae`` updated in
    place. ``data`` = (text, R rows, C rows), each (items, ...);
    ``step_draws(shape)`` gives a step's (B, vocab) keep mask. Returns (the
    two optimizer states, the summed loss of the second steps, a device
    scalar). ``mesh``: each rank takes its share of every minibatch
    (module docstring)."""
    opt_cf, opt_ae = opts
    state_cf, state_ae = states
    text, R_t, C_t = data
    loss_sum = torch.zeros((), dtype=torch.float32, device=order.device)
    share = Share(mesh, batch_size)

    def grads_of(loss, tensors):
        grads = torch.autograd.grad(loss, tensors, materialize_grads=True)
        return grads if mesh is None else sum_grads(mesh, grads, None)

    for s in range(0, order.shape[0], batch_size):
        whole = order[s: s + batch_size]
        mask = share.take(step_draws((whole.shape[0], text.shape[1])))
        ids = share.take(whole)
        x_clean = text[ids]
        x_corrupt = x_clean * mask
        R_rows, C_rows = R_t[ids], C_t[ids]
        frozen = {k: p.detach() for k, p in sdae.items()}
        loss = cdl_loss(params, frozen, ids, x_corrupt, x_clean, R_rows, C_rows, act, lambdas,
                        share.first)
        grads = grads_of(loss, [params["U"], params["V"]])
        updates, state_cf = opt_cf.update(dict(zip(("U", "V"), grads)), state_cf, params)
        apply_updates(params, updates)
        fixed = {k: p.detach() for k, p in params.items()}
        loss = cdl_loss(fixed, sdae, ids, x_corrupt, x_clean, R_rows, C_rows, act, lambdas,
                        share.first)
        grads = grads_of(loss, list(sdae.values()))
        updates, state_ae = opt_ae.update(dict(zip(sdae, grads)), state_ae, sdae)
        apply_updates(sdae, updates)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    return (state_cf, state_ae), loss_sum


def keep_mask_draws(gen, keep):
    """``step_draws(shape)``: a float32 Bernoulli(``keep``) mask of
    ``shape`` from ``gen``, one call a step."""
    def draw(shape):
        return (torch.rand(shape, generator=gen, device=gen.device) < keep).to(torch.float32)
    return draw


class _FactorScores(Recommender, ANNMixin):
    """Scoring of U V^T, shared by CDL, CDR and CVAE."""

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

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.V


class CDL(_FactorScores):
    """SDAE-regularised weighted MF over item text.

    Parameters mirror the JAX package: ``k``, ``autoencoder_structure``,
    ``act_fn``, ``lambda_u``, ``lambda_v``, ``lambda_w``, ``lambda_n``,
    ``a``, ``b``, ``corruption_rate``, ``learning_rate``, ``vocab_size``
    (set to the text's width by ``fit``), ``dropout_rate`` (unused, as
    there), ``batch_size``, ``max_iter``, ``init_params`` ({'U', 'V'}),
    ``seed`` (the generator is made here, so a second fit goes on drawing
    from it). ``device``: where the model trains and scores (default: the
    card). ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls
    ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="CDL",
        k=50,
        autoencoder_structure=None,
        act_fn="relu",
        lambda_u=0.1,
        lambda_v=10,
        lambda_w=0.1,
        lambda_n=1000,
        a=1,
        b=0.01,
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
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.k = k
        self.autoencoder_structure = (
            [200] if autoencoder_structure is None else list(autoencoder_structure))
        self.act_fn = act_fn
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_w = lambda_w
        self.lambda_n = lambda_n
        self.a = a
        self.b = b
        self.corruption_rate = corruption_rate
        self.learning_rate = learning_rate
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.seed = seed
        self.rng = get_rng(seed)

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def _initial(self, rng, vocab):
        """The autoencoder's initial layers from ``rng``: the encoder, then
        the decoder, as a flat dict of float32 arrays."""
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
        self.vocab_size = text.shape[1]
        dev = self._device()
        sdae = {n: torch.tensor(a, device=dev, requires_grad=True)
                for n, a in self._initial(rng, text.shape[1]).items()}
        params = {n: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for n, a in (("U", self.U), ("V", self.V))}
        R_t = dense_rows(train_set, dev, by="item")
        data = (torch.as_tensor(text, device=dev), R_t,
                torch.where(R_t != 0, float(self.a), float(self.b)))
        opts = (adam(self.learning_rate), adam(self.learning_rate))
        states = (opts[0].init(params), opts[1].init(sdae))
        act = ACTIVATIONS[self.act_fn]
        lambdas = (self.lambda_u, self.lambda_v, self.lambda_w, self.lambda_n)
        bsz = round_batch(self.mesh, min(self.batch_size, self.num_items))
        n_total = self.num_items + (-self.num_items) % bsz
        keep = 1.0 - self.corruption_rate
        seed = rng.randint(2**31)
        for it in range(self.max_iter):
            gen = epoch_generator(seed, it, dev)
            order = _epoch_permutation(n_total, gen) % self.num_items
            states, loss_sum = cdl_epoch(params, sdae, opts, states, order, data,
                                         keep_mask_draws(gen, keep), bsz, act, lambdas, self.mesh)
            if self.verbose:
                print("Iter %d/%d, loss: %.2f" % (it + 1, self.max_iter,
                                                  float(loss_sum) / n_total))

        self.sdae = {n: p.detach() for n, p in sdae.items()}
        self.U = params["U"].detach().cpu().numpy().astype(np.float64)
        self.V = params["V"].detach().cpu().numpy().astype(np.float64)
        return self
