"""PCRL — Probabilistic Collaborative Representation Learning
(Salah & Lauw, UAI 2018).

Port of ``cornac_tpu/models/pcrl.py``: Poisson factorization of the
ratings alternating with a neural Gamma inference network over the items'
context (the dense item-graph matrix ``C``, which stays on the model's
device), trained on the ELBO: the Poisson reconstruction of the context
and the analytic Gamma-Gamma KL against the PF side's prior, by RMSProp
(optax's rule, ``ops.optim.rmsprop``).

The Gamma sample is implicitly reparameterised, as ``jax.random.gamma``'s
is: ``ReparamGamma`` passes a standard Gamma draw through with the
gradient ``torch._standard_gamma_grad`` gives (what
``torch.distributions.Gamma.rsample`` uses), so the draw can come from the
fit's generator or, in a test, from the JAX key. Each epoch (the PF sweep,
the network's minibatches, the refresh of the items' Gamma parameters)
takes its draws from one ``torch.Generator`` seeded from (the fit's seed,
the epoch index): for each minibatch, when ``w_determinist`` is false, the
generator's weight noise layer by layer, then the Gamma draw.
The PF sweep's scatters sum through ``accumulate_rows``.

``mesh`` (``parallel.make_mesh``): the Gamma tables and the nets are
replicated, as in the JAX package. The PF sweep's rating edges are split
over "data": each rank computes its slice's per-edge terms and the slices
are gathered back in edge order before the sums (``data_parallel``), as
HPF's sweep keeps the single-device bits. The network's item batches,
rounded down to a multiple of the mesh's size as in the JAX package, are
data-parallel over every rank: a rank infers its rows, the Gamma draw is
made for the whole batch (the ranks' shape parameters gathered) and cut,
the rank's terms are taken over the whole batch's size, and
``ops.optim.step`` sums the gradients.
"""

import functools

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.optim import rmsprop, step
from ..parallel.mesh import DATA_AXIS, check_mesh
from ..parallel.sharded import Share, all_sum, data_parallel, round_batch
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog
from .vaecf import batch_mean
from .vbpr import softplus

EPS = 1e-10
AA = 0.3  # Gamma prior shape hyper (reference pcrl.py:51-52)
BB = 0.3


def _glorot(rng, shape):
    std = 1.0 / np.sqrt(shape[0] / 2.0)
    return rng.normal(0.0, std, size=shape).astype(np.float32)


def init_nets(rng, c_dim, z_dims, k):
    """The inference and generator nets' weights ({"inf": [...], "gen":
    [...]}, numpy float32), drawn from ``rng`` in the JAX package's order."""
    L = len(z_dims)
    inf = [_glorot(rng, (c_dim, z_dims[L - 1]))]
    for l in range(L - 2, -1, -1):
        inf.append(_glorot(rng, (z_dims[l + 1], z_dims[l])))
    inf.append(_glorot(rng, (z_dims[0], k)))  # -> beta head
    inf.append(_glorot(rng, (z_dims[0], k)))  # -> alpha head
    gen = [_glorot(rng, (k, z_dims[0]))]
    for l in range(1, L):
        gen.append(_glorot(rng, (z_dims[l - 1], z_dims[l])))
    gen.append(_glorot(rng, (z_dims[L - 1], c_dim)))
    return {"inf": inf, "gen": gen}


def flat_params(nets):
    """{"inf.0": ..., "gen.2": ...}: the nets' weights under flat names."""
    return {f"{side}.{l}": W for side in ("inf", "gen") for l, W in enumerate(nets[side])}


def _layers(params, side):
    return [params[f"{side}.{l}"] for l in range(sum(1 for k in params if k.startswith(side)))]


def inference(params, C):
    """(alpha, beta) of the items' Gamma posteriors from their context
    rows."""
    inf = _layers(params, "inf")
    h = C
    for W in inf[:-2]:
        h = torch.relu(h @ W)
    beta = softplus(h @ inf[-2]) + 0.3
    alpha = softplus(h @ inf[-1]) + 0.3
    return alpha, beta


def generate(params, z, noise):
    """The generator's reconstruction of the context from ``z``; ``noise``:
    one array per layer added to its weights (None: deterministic)."""
    gen = _layers(params, "gen")
    h = z
    for l, W in enumerate(gen):
        if noise is not None:
            W = W + 0.01 * noise[l]
        h = h @ W
        if l < len(gen) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


class ReparamGamma(torch.autograd.Function):
    """A standard Gamma draw ``sample`` of shape ``alpha``, passed through
    with the implicit reparameterisation gradient d sample / d alpha
    (``torch._standard_gamma_grad``, ``Gamma.rsample``'s)."""

    @staticmethod
    def forward(ctx, alpha, sample):
        ctx.save_for_backward(alpha, sample)
        return sample

    @staticmethod
    def backward(ctx, grad):
        alpha, sample = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, sample), None


def gamma_draw(gen):
    """A draw function for ``elbo_loss``: standard Gamma draws of
    ``alpha``'s shape from ``gen``."""
    return lambda alpha: torch._standard_gamma(alpha.detach(), generator=gen)


def elbo_loss(params, C, Zik, Tk, draw, noise, share=None):
    """The JAX package's ``_elbo_loss``: minus the mean of the Poisson
    log-likelihood of the context rows ``C`` and the Gamma-Gamma KL against
    the prior Gamma(AA + Zik, BB + Tk), plus the weights' Gaussian KL over
    the batch when ``noise`` is given. ``draw(alpha)`` gives the standard
    Gamma draw the sample is made of. ``share``
    (``parallel.sharded.Share``): ``C`` and ``Zik`` are a rank's rows of a
    batch, the draw is made for the whole batch (the ranks' ``alpha``
    gathered) and cut, and the loss is the rank's share (the weights' KL on
    the first rank)."""
    alpha, beta = inference(params, C)
    if share is None:
        sample = draw(alpha)
    else:
        sample = share.take(draw(share.gather(alpha.detach())))
    z = ReparamGamma.apply(alpha, sample) / beta
    X_g = generate(params, z, noise)
    ll = (C * torch.log(EPS + X_g) - X_g).sum(1)
    kl = ((alpha - AA - Zik) * torch.digamma(alpha) - torch.lgamma(alpha)
          + (AA + Zik) * torch.log(beta) + alpha * (Tk + BB - beta) / beta)
    loss = -batch_mean(ll - kl.sum(1), None if share is None else share.n)
    if noise is not None and (share is None or share.first):
        kl_w = sum((-0.5 * (W ** 2).sum(1)).sum() for W in _layers(params, "gen"))
        loss = loss + kl_w / (C.shape[0] if share is None else share.n)
    return loss


def _edge_terms(Lt, Lb, rid, cid, val):
    """Each rating edge's terms of the two sums: ratio * Lb[cid] (into its
    user) and ratio * Lt[rid] (into its item)."""
    lt_e, lb_e = Lt[rid], Lb[cid]
    ratio = val / ((lt_e * lb_e).sum(1) + EPS)
    return ratio[:, None] * lb_e, ratio[:, None] * lt_e


def pf_sweep(G_s, G_r, L_s, L_r, rid, cid, val, mesh=None):
    """One Poisson-factorization coordinate sweep (the reference's ``pf_``):
    the users' new Gamma parameters, the items' sufficient statistics Zik
    and the users' mass Tk. The scatters sum through ``accumulate_rows``.
    ``mesh``: the edges' terms are computed slice-wise over "data" and
    gathered back in edge order (``data_parallel``), the same bits."""
    Lt = torch.exp(torch.digamma(G_s) - torch.log(torch.clamp_min(G_r, EPS)))
    Lb = torch.exp(torch.digamma(L_s) - torch.log(torch.clamp_min(L_r, EPS)))
    to_users, to_items = data_parallel(mesh, functools.partial(_edge_terms, Lt, Lb),
                                       val.shape[0], rid, cid, val, axis=DATA_AXIS)
    G_s_new = AA + Lt * accumulate_rows(torch.zeros_like(G_s), rid, to_users)
    G_r_new = ((L_s / torch.clamp_min(L_r, EPS)).sum(0)[None, :] + AA).expand_as(G_s)
    Zik = Lb * accumulate_rows(torch.zeros_like(L_s), cid, to_items)
    Tk = (G_s_new / torch.clamp_min(G_r_new, EPS)).sum(0)
    return G_s_new, G_r_new.contiguous(), Zik, Tk


def pcrl_epoch(params, opt, opt_state, tables, ratings, C, bsz, draws, mesh=None):
    """One epoch: the PF sweep, RMSProp steps over the context rows in
    minibatches of ``bsz`` (``C`` padded to whole minibatches), then the
    items' Gamma parameters from the network. ``draws(b)`` gives minibatch
    b's (draw function, weight noise or None). Returns (the new state, the
    new tables (G_s, G_r, L_s, L_r), the summed loss). ``mesh``: the sweep's
    edges split over "data", each minibatch over every rank (module
    docstring)."""
    G_s, G_r, L_s, L_r = tables
    d, k = L_s.shape
    G_s, G_r, Zik, Tk = pf_sweep(G_s, G_r, L_s, L_r, *ratings, mesh=mesh)
    n_pad = C.shape[0] - d
    if n_pad:
        Zik = torch.cat([Zik, Zik.new_zeros((n_pad, k))])
    loss_sum = torch.zeros((), dtype=torch.float32, device=C.device)
    share = None if mesh is None else Share(mesh, bsz)
    for b in range(C.shape[0] // bsz):
        rows = slice(b * bsz, (b + 1) * bsz)
        if share is not None:
            rows = slice(rows.start + share.lo, rows.start + share.hi)
        draw, noise = draws(b)
        loss = elbo_loss(params, C[rows], Zik[rows], Tk[None, :], draw, noise, share)
        opt_state = step(params, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    with torch.no_grad():
        alpha, beta = inference(params, C)
    return opt_state, (G_s, G_r, alpha[:d].contiguous(), beta[:d].contiguous()), loss_sum


class PCRL(Recommender, ANNMixin):
    """Poisson CF and a neural Gamma representation of the items' context.

    Parameters mirror the JAX package: ``k``, ``z_dims`` (the nets' hidden
    widths), ``max_iter``, ``batch_size``, ``learning_rate``,
    ``w_determinist`` (no weight noise), ``init_params`` ({'G_s', 'G_r',
    'L_s', 'L_r'}), ``seed``. ``device``: where the model trains and
    scores (default: the card). ``mesh``: a ``parallel.make_mesh`` mesh;
    every rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        k=100,
        z_dims=None,
        max_iter=300,
        batch_size=300,
        learning_rate=0.001,
        name="PCRL",
        trainable=True,
        verbose=False,
        w_determinist=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.z_dims = [300] if z_dims is None else list(z_dims)
        self.max_iter = max_iter
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.w_determinist = w_determinist
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.Theta = self.init_params.get("Theta", None)
        self.Beta = self.init_params.get("Beta", None)
        self.Gs = self.init_params.get("G_s", None)
        self.Gr = self.init_params.get("G_r", None)
        self.Ls = self.init_params.get("L_s", None)
        self.Lr = self.init_params.get("L_r", None)

    def draws(self, gen, params):
        """Minibatch draws from ``gen`` for ``pcrl_epoch``: without
        ``w_determinist`` the generator's weight noise, layer by layer, then
        (inside the loss) the Gamma draw."""
        def of_batch(b):
            noise = None
            if not self.w_determinist:
                noise = [torch.randn(W.shape, generator=gen, device=W.device)
                         for W in _layers(params, "gen")]
            return gamma_draw(gen), noise
        return of_batch

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self
        if train_set.item_graph is None:
            raise ValueError("PCRL requires an item_graph modality")

        rng = get_rng(self.seed)
        n, d, k = self.num_users, self.num_items, self.k
        aux = train_set.item_graph.matrix[:d, :d]
        C_np = np.asarray(aux.todense(), dtype=np.float32)
        c_dim = C_np.shape[1]
        dev = self._device()
        rid, cid, val = train_set.uir_tuple
        ratings = (torch.as_tensor(np.asarray(rid, np.int64), device=dev),
                   torch.as_tensor(np.asarray(cid, np.int64), device=dev),
                   torch.as_tensor(np.asarray(val, np.float32), device=dev))

        def tbl(existing, rows):
            if existing is None:
                existing = rng.gamma(50, scale=0.3 / 50, size=(rows, k))
            return torch.as_tensor(np.asarray(existing, np.float32), device=dev)

        tables = (tbl(self.Gs, n), tbl(self.Gr, n), tbl(self.Ls, d), tbl(self.Lr, d))
        params = {name: torch.tensor(W, device=dev, requires_grad=True)
                  for name, W in flat_params(init_nets(rng, c_dim, self.z_dims, k)).items()}
        opt = rmsprop(self.learning_rate)
        opt_state = opt.init(params)
        bsz = round_batch(self.mesh, min(self.batch_size, d))
        n_pad = (-d) % bsz
        C = torch.as_tensor(C_np, device=dev)
        if n_pad:
            C = torch.cat([C, C.new_zeros((n_pad, c_dim))])
        seed = rng.randint(2**31)
        for it in range(self.max_iter):
            gen = epoch_generator(seed, it, dev)
            opt_state, tables, loss = pcrl_epoch(params, opt, opt_state, tables, ratings, C, bsz,
                                                 self.draws(gen, params), self.mesh)
            if self.verbose:
                print("epoch %d, Train Loss: %f" % (it, float(loss)))
        # the final user update against the learned item representation
        G_s, G_r, _, _ = pf_sweep(*tables, *ratings, mesh=self.mesh)

        self.params = {name: t.detach() for name, t in params.items()}
        self.Gs, self.Gr = G_s.cpu().numpy(), G_r.cpu().numpy()
        self.Ls, self.Lr = tables[2].cpu().numpy(), tables[3].cpu().numpy()
        self.Theta = self.Gs / np.maximum(self.Gr, EPS)
        self.Beta = self.Ls / np.maximum(self.Lr, EPS)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is None:
            return self.Beta @ self.Theta[user_idx]
        if self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        return float(self.Theta[user_idx] @ self.Beta[item_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = (self.Theta[np.where(known, users, 0)] @ self.Beta.T).astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.Theta

    def get_item_vectors(self):
        return self.Beta
