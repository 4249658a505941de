"""VBPR — Visual BPR (He & McAuley, AAAI 2016), and AMR (Tang et al., TKDE
2020), which hardens it with adversarial noise on the visual features.

Port of ``cornac_tpu/models/vbpr.py``: six tables (item bias ``Bi``, latent
factors ``Gu``/``Gi``, visual user factors ``Tu``, the visual projection
``E`` and the visual bias projection ``Bp``), the BPR loss over sampled
(user, positive, negative) triplets, Adam (optax's rule, ``ops.optim.adam``)
over all six tables every step. The item features stay on the model's
device for the whole fit. Each epoch draws |R| rounded up to whole
minibatches of (positive pair, negative item) uniformly with replacement
from a ``torch.Generator`` seeded from (the fit's seed, the global epoch
index), as the JAX package draws them from its key (``vbpr_draws``); no
draw is masked. The gradients of the row gathers sum through the
deterministic ``accumulate_rows`` (``ops.accumulate.gather_rows``), so a
seeded fit gives the same bits on every run. AMR's FGSM perturbation is the
sign of the inner gradient with respect to the gathered features, taken
with ``torch.autograd.grad`` and used detached: in the JAX package the sign
carries no gradient either. Nothing syncs with the host inside an epoch.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank, as
the JAX package shards each minibatch over all mesh axes: every rank draws
the epoch's whole stream and takes the loss of its rows of each minibatch
over the whole minibatch's size (the visual projections' penalty on rank 0
alone), and ``ops.optim.step`` sums the gradients, so every rank applies
the same Adam update to its replica. AMR's FGSM sign is a row's own: the
gradient of the mean with respect to a row's features is that row's.
"""

import numpy as np
import torch

from ..exception import CornacException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot
from ..ops.dispatch import full_f32
from ..ops.optim import adam, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import xavier_uniform, zeros
from .recommender import ANNMixin, MEASURE_DOT, Recommender
from .vaecf import batch_mean

TABLES = ("Bi", "Gu", "Gi", "Tu", "E", "Bp")


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def vbpr_draws(gen, n, n_total, num_items):
    """An epoch's draws from ``gen``: (positive pair index, negative item),
    ``n_total`` of each, uniform with replacement."""
    dev = gen.device
    pos_idx = torch.randint(n, (n_total,), generator=gen, device=dev)
    negs = torch.randint(num_items, (n_total,), generator=gen, device=dev)
    return pos_idx, negs


def _pair_scores(params, gu, tu, rows, feat, count):
    """The scores of ``count`` users (gathered rows ``gu``, ``tu``) against
    each of the stacked item blocks: ``rows`` the gathered (Bi, Gi) of the
    items, ``feat`` their features."""
    bi, gi = rows
    theta = feat @ params["E"]
    visual_bias = (feat @ params["Bp"]).reshape(-1)
    reps = gi.shape[0] // count
    return (bi + visual_bias + (gu.repeat(reps, 1) * gi).sum(1)
            + (tu.repeat(reps, 1) * theta).sum(1))


def vbpr_loss(params, F, u, i, j, hyper, adversarial, share=None):
    """The JAX package's ``loss_fn`` on the triplets (u, i, j): the mean
    softplus BPR loss (plus ``lambda_adv`` times the loss on the FGSM-
    perturbed features, for AMR) and the regulariser over the gathered rows
    (and E, Bp times ``lambda_e``), divided by the batch size. ``hyper``:
    (lambda_w, lambda_b, lambda_e, lambda_adv, epsilon_adv). ``share``
    (``parallel.sharded.Share``): (u, i, j) are a rank's rows of a
    minibatch of ``share.n``, and the loss is its share of the
    minibatch's."""
    lw, lb, le, adv_lambda, adv_eps = hyper
    B = u.shape[0]
    whole = B if share is None else share.n
    denom = None if share is None else whole
    ij = torch.cat([i, j])
    gu, tu = gather_rows(params["Gu"], u), gather_rows(params["Tu"], u)
    rows = (gather_rows(params["Bi"], ij), gather_rows(params["Gi"], ij))

    def core(feat):
        x = _pair_scores(params, gu, tu, rows, feat, B)
        return batch_mean(softplus(-(x[:B] - x[B:])), denom)

    feat = F[ij]
    if adversarial:
        feat.requires_grad_(True)
    loss = core(feat)
    if adversarial:
        # FGSM on the visual features: the sign of the inner gradient,
        # which carries no gradient itself
        (g_feat,) = torch.autograd.grad(loss, [feat], retain_graph=True)
        loss = loss + adv_lambda * core(feat.detach() + adv_eps * torch.sign(g_feat))
    gi, bi = rows[1], rows[0]
    reg = (lw * ((gu * gu).sum() + (gi[:B] * gi[:B]).sum() + (gi[B:] * gi[B:]).sum()
                 + (tu * tu).sum())
           + lb * (bi[:B] * bi[:B]).sum() + lb * (bi[B:] * bi[B:]).sum())
    if share is None or share.first:
        reg = reg + le * ((params["E"] ** 2).sum() + (params["Bp"] ** 2).sum())
    return loss + reg / whole


def vbpr_epoch(params, opt, opt_state, draws, pairs, F, hyper, batch_size, adversarial,
               mesh=None):
    """One epoch of Adam steps on the draws (``vbpr_draws``' pair), updating
    ``params`` in place. Returns (the new state, the summed loss, a device
    scalar). ``mesh``: each rank takes its share of every minibatch
    (module docstring)."""
    pos_idx, negs = draws
    users, items = pairs[pos_idx].unbind(1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=pairs.device)
    share = None if mesh is None else Share(mesh, batch_size)
    for s in range(0, pos_idx.shape[0], batch_size):
        sl = slice(s, s + batch_size)
        u, i, j = users[sl], items[sl], negs[sl]
        if share is not None:
            u, i, j = share.take(u), share.take(i), share.take(j)
        loss = vbpr_loss(params, F, u, i, j, hyper, adversarial, share)
        opt_state = step(params, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    return opt_state, loss_sum


class VBPR(Recommender, ANNMixin):
    """BPR over latent and projected-visual item representations.

    Parameters mirror the JAX package: ``k``, ``k2`` (the visual factors),
    ``n_epochs``, ``batch_size``, ``learning_rate``, ``lambda_w``,
    ``lambda_b``, ``lambda_e``, ``use_gpu`` (kept for the signature),
    ``init_params`` ({'Bi', 'Gu', 'Gi', 'Tu', 'E', 'Bp'}), ``seed``.
    ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``
    (module docstring).
    """

    _adversarial = False
    _adv_lambda = 0.0
    _adv_epsilon = 0.0

    def __init__(
        self,
        name="VBPR",
        k=10,
        k2=10,
        n_epochs=50,
        batch_size=100,
        learning_rate=0.005,
        lambda_w=0.01,
        lambda_b=0.01,
        lambda_e=0.0,
        use_gpu=False,
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
        self.k2 = k2
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.lambda_w = lambda_w
        self.lambda_b = lambda_b
        self.lambda_e = lambda_e
        self.use_gpu = use_gpu
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.beta_item = self.init_params.get("Bi", None)
        self.gamma_user = self.init_params.get("Gu", None)
        self.gamma_item = self.init_params.get("Gi", None)
        self.theta_user = self.init_params.get("Tu", None)
        self.emb_matrix = self.init_params.get("E", None)
        self.beta_prime = self.init_params.get("Bp", None)

    def _init(self, n_users, n_items, f_dim):
        rng = get_rng(self.seed)
        if self.beta_item is None:
            self.beta_item = zeros(n_items)
        if self.gamma_user is None:
            self.gamma_user = xavier_uniform((n_users, self.k), rng)
        if self.gamma_item is None:
            self.gamma_item = xavier_uniform((n_items, self.k), rng)
        if self.theta_user is None:
            self.theta_user = xavier_uniform((n_users, self.k2), rng)
        if self.emb_matrix is None:
            self.emb_matrix = xavier_uniform((f_dim, self.k2), rng)
        if self.beta_prime is None:
            self.beta_prime = xavier_uniform((f_dim, 1), rng)

    def _arrays(self):
        return (self.beta_item, self.gamma_user, self.gamma_item, self.theta_user,
                self.emb_matrix, self.beta_prime)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.item_image is None:
            raise CornacException("this model needs the item_image modality attached to the "
                                  "eval method")

        features = np.asarray(train_set.item_image.features[: self.total_items],
                              dtype=np.float32)
        self._init(self.total_users, self.total_items, features.shape[1])
        dev = self._device()
        F = torch.as_tensor(features, device=dev)
        if not self.trainable:
            self._finalize(F)
            return self

        rng = get_rng(self.seed)
        params = {name: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for name, a in zip(TABLES, self._arrays())}
        rid, cid, _ = train_set.uir_tuple
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        n = len(rid)
        bsz = min(self.batch_size, n)
        n_batches = (n + bsz - 1) // bsz
        num_items = train_set.num_items
        hyper = (self.lambda_w, self.lambda_b, self.lambda_e, self._adv_lambda,
                 self._adv_epsilon)
        opt = adam(self.learning_rate)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                draws = vbpr_draws(epoch_generator(seed, epoch, dev), n, n_batches * bsz,
                                   num_items)
                opt_state, loss_sum = vbpr_epoch(params, opt, opt_state, draws, pairs, F, hyper,
                                                 bsz, self._adversarial, self.mesh)
            return opt_state, loss_sum

        epoch_loop(self, self.n_epochs, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Epoch %d/%d, loss: %.4f" % (done, self.n_epochs,
                                                    float(loss) / n_batches)))

        (self.beta_item, self.gamma_user, self.gamma_item, self.theta_user, self.emb_matrix,
         self.beta_prime) = (params[name].detach().cpu().numpy() for name in TABLES)
        self._finalize(F)
        return self

    def _finalize(self, F):
        """The projected visual representations, for fast scoring
        (``F @ E`` and ``F @ Bp`` on the features' device, in float32)."""
        with full_f32():
            E = torch.as_tensor(np.asarray(self.emb_matrix, np.float32), device=F.device)
            Bp = torch.as_tensor(np.asarray(self.beta_prime, np.float32), device=F.device)
            self.theta_item = (F @ E).cpu().numpy()
            self.visual_bias = (F @ Bp).reshape(-1).cpu().numpy()

    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            return (self.beta_item + self.visual_bias
                    + self.gamma_item @ self.gamma_user[user_idx]
                    + self.theta_item @ self.theta_user[user_idx])
        return (self.beta_item[item_idx] + self.visual_bias[item_idx]
                + self.gamma_item[item_idx] @ self.gamma_user[user_idx]
                + self.theta_item[item_idx] @ self.theta_user[user_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        base = self.beta_item + self.visual_bias
        scores = (base[None, :] + self.gamma_user[users] @ self.gamma_item.T
                  + self.theta_user[users] @ self.theta_item.T)
        return scores.astype(np.float64)

    def _known_scores_device(self, safe_users, known):
        return device_dot(self.get_user_vectors()[safe_users], self.get_item_vectors(),
                          self._device())

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        return (self.beta_item[items] + self.visual_bias[items]
                + np.sum(self.gamma_user[users] * self.gamma_item[items], axis=1)
                + np.sum(self.theta_user[users] * self.theta_item[items], axis=1))

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return np.concatenate(
            (self.gamma_user, self.theta_user, np.ones([self.gamma_user.shape[0], 1])), axis=1)

    def get_item_vectors(self):
        return np.concatenate(
            (self.gamma_item, self.theta_item,
             (self.beta_item + self.visual_bias).reshape((-1, 1))), axis=1)


class AMR(VBPR):
    """Adversarial Multimedia Recommendation: VBPR hardened with FGSM
    perturbations of the visual features (``lambda_adv`` weighs the loss on
    the perturbed features, ``epsilon_adv`` sizes the perturbation)."""

    _adversarial = True

    def __init__(
        self,
        name="AMR",
        k=10,
        k2=10,
        n_epochs=50,
        batch_size=100,
        learning_rate=0.005,
        lambda_w=0.01,
        lambda_b=0.01,
        lambda_e=0.0,
        lambda_adv=1.0,
        epsilon_adv=0.05,
        use_gpu=False,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, k=k, k2=k2, n_epochs=n_epochs, batch_size=batch_size,
                         learning_rate=learning_rate, lambda_w=lambda_w, lambda_b=lambda_b,
                         lambda_e=lambda_e, use_gpu=use_gpu, trainable=trainable,
                         verbose=verbose, init_params=init_params, seed=seed, mesh=mesh,
                         device=device)
        self.lambda_adv = lambda_adv
        self.epsilon_adv = epsilon_adv
        self._adv_lambda = lambda_adv
        self._adv_epsilon = epsilon_adv
