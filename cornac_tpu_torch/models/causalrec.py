"""CausalRec (Qiu et al., MM 2021): causally debiased visual recommendation.

Port of ``cornac_tpu/models/causalrec.py``: Adam (optax's rule,
``ops.optim.adam``) over BPR-style triplets with the multimodal causal
graph (the item branch m, the visual branch n, fused sigmoid scores) and
the counterfactual removal of the visual bias at inference. The visual
transformations ``tanh`` 0, 1 or 2 are the JAX package's. Each epoch draws
|R| rounded up to whole minibatches of (positive pair, negative item)
uniformly with replacement from a ``torch.Generator`` seeded from (the
fit's seed, the global epoch index), as ``models/vbpr.py::vbpr_draws``
draws them; a negative the user has observed is masked out of the
likelihood (``ops.membership``), not dropped. The item features stay on
the model's device; the gradients of the row gathers sum through
``accumulate_rows``. Nothing syncs with the host inside an epoch.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank,
the minibatch rounded down to a multiple of the mesh's size as in the JAX
package: every rank draws the whole stream and sums the terms of its rows
of each minibatch (the visual projections' penalty on rank 0 alone), and
``ops.optim.step`` sums the gradients.
"""

import numpy as np
import torch

from ..exception import CornacException
from ..ops.accumulate import gather_rows
from ..ops.dispatch import full_f32
from ..ops.membership import build_membership
from ..ops.optim import adam, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.init_utils import xavier_uniform, zeros
from .recommender import Recommender
from .vbpr import softplus, vbpr_draws


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def visual(params, feat, which, tanh):
    """The visual transformation of ``feat`` through ``params[which]``:
    linear (``tanh`` 0), through a tanh (1), or through a second tanh
    layer ``params[which + "2"]`` (2)."""
    h = feat @ params[which]
    if tanh == 0:
        return h
    h = torch.tanh(h)
    if tanh == 1:
        return h
    return torch.tanh(h @ params[which + "2"])


def causalrec_loss(params, F, u, i, j, mvalid, hyper, tanh, dense=True):
    """The JAX package's ``loss_fn`` on the triplets (u, i, j) with the
    float32 mask ``mvalid`` (0 where the negative was observed). ``hyper``:
    (lambda_w, lambda_b, lambda_e). With ``dense`` False (a rank of a mesh
    but the first) the visual projections' penalty is left out: every
    other term is a sum over the rows."""
    lw, lb, le = hyper
    B = u.shape[0]
    ij = torch.cat([i, j])
    gu, tu = gather_rows(params["Gu"], u), gather_rows(params["Tu"], u)
    bi, gi = gather_rows(params["Bi"], ij), gather_rows(params["Gi"], ij)
    feat = F[ij]
    direct = visual(params, feat, "E", tanh)
    ind = visual(params, feat, "E_ind", tanh)
    gu2, tu2 = gu.repeat(2, 1), tu.repeat(2, 1)
    m = bi + (gu2 * gi).sum(1) + (gu2 * (gi * ind)).sum(1)
    nb = (tu2 * direct).sum(1) + (feat @ params["Bp"]).reshape(-1)
    score = torch.sigmoid(m + nb) * torch.sigmoid(m) * torch.sigmoid(nb)
    ll = (log_sigmoid(score[:B] - score[B:]) * mvalid).sum()
    ll_m = (log_sigmoid(m[:B] - m[B:]) * mvalid).sum()
    ll_n = (log_sigmoid(nb[:B] - nb[B:]) * mvalid).sum()
    names = ["E", "Bp", "E_ind"] + (["E2", "E_ind2"] if tanh == 2 else [])
    reg = (0.5 * lw * ((gu * gu).sum() + (gi[:B] * gi[:B]).sum() + (gi[B:] * gi[B:]).sum()
                       + (tu * tu).sum())
           + 0.5 * lb * (bi[:B] * bi[:B]).sum() + 0.5 * lb / 10 * (bi[B:] * bi[B:]).sum())
    if dense:
        reg = reg + le * sum(0.5 * (params[name] ** 2).sum() for name in names)
    return -ll + reg - ll_m - ll_n


def causalrec_epoch(params, opt, opt_state, draws, pairs, membership, F, hyper, batch_size,
                    tanh, mesh=None):
    """One epoch of Adam steps on the draws (``vbpr_draws``' pair), the
    observed negatives masked, updating ``params`` in place. Returns (the
    new state, the summed loss, a device scalar). ``mesh``: each rank takes
    its share of every minibatch (module docstring)."""
    pos_idx, negs = draws
    users, pos = pairs[pos_idx].unbind(1)
    valid = (~membership.query(users, negs)).to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=pairs.device)
    share = Share(mesh, batch_size)
    for s in range(0, pos_idx.shape[0], batch_size):
        sl = slice(s, s + batch_size)
        loss = causalrec_loss(params, F, *(share.take(a[sl]) for a in (users, pos, negs, valid)),
                              hyper, tanh, share.first)
        opt_state = step(params, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    return opt_state, loss_sum


class CausalRec(Recommender):
    """Visual BPR with the counterfactual removal of the visual bias.

    Parameters mirror the JAX package: ``k``, ``k2``, ``n_epochs``,
    ``batch_size``, ``learning_rate``, ``lambda_w``, ``lambda_b``,
    ``lambda_e``, ``mean_feat`` (the mean item feature, default: the
    features' mean), ``tanh`` (0, 1 or 2), ``lambda_2`` (the weight of the
    removed bias), ``use_gpu`` (kept for the signature), ``init_params``,
    ``seed``. ``device``: where the model trains (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``
    (module docstring).
    """

    def __init__(
        self,
        name="CausalRec",
        k=10,
        k2=10,
        n_epochs=50,
        batch_size=100,
        learning_rate=0.005,
        lambda_w=0.01,
        lambda_b=0.01,
        lambda_e=0.0,
        mean_feat=None,
        tanh=0,
        lambda_2=0.8,
        use_gpu=False,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.k2 = k2
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.lambda_w = lambda_w
        self.lambda_b = lambda_b
        self.lambda_e = lambda_e
        self.mean_feat_init = mean_feat
        self.tanh = tanh
        self.lambda_2 = lambda_2
        self.use_gpu = use_gpu
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.init_params = {} if init_params is None else init_params

    def _initial(self, f_dim, rng):
        """The initial tables as numpy float32, drawn from ``rng`` in the
        JAX package's order (every draw made, even for a table
        ``init_params`` gives)."""
        nu, ni, k, k2 = self.total_users, self.total_items, self.k, self.k2
        shapes = [("Gu", (nu, k)), ("Gi", (ni, k)), ("Tu", (nu, k2)), ("E", (f_dim, k2)),
                  ("E_ind", (f_dim, k)), ("Bp", (f_dim, 1))]
        if self.tanh == 2:
            shapes += [("E2", (k2, k2)), ("E_ind2", (k, k))]
        out = {"Bi": self.init_params.get("Bi", zeros(ni))}
        for name, shape in shapes:
            drawn = xavier_uniform(shape, rng)
            out[name] = self.init_params.get(name, drawn)
        return {name: np.asarray(a, np.float32) for name, a in out.items()}

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.item_image is None:
            raise CornacException("this model needs the item_image modality attached to the "
                                  "eval method")

        rng = get_rng(self.seed)
        features = np.asarray(train_set.item_image.features[: self.total_items],
                              dtype=np.float32)
        mean_feat = (np.asarray(self.mean_feat_init, dtype=np.float32)
                     if self.mean_feat_init is not None else features.mean(axis=0)).reshape(1, -1)
        dev = self._device()
        F = torch.as_tensor(features, device=dev)
        params = {name: torch.tensor(a, device=dev, requires_grad=True)
                  for name, a in self._initial(features.shape[1], rng).items()}
        if not self.trainable:
            self._store(params, F, mean_feat)
            return self

        rid, cid, _ = train_set.uir_tuple
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        n = len(rid)
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_batches = (n + bsz - 1) // bsz
        num_items = train_set.num_items
        hyper = (self.lambda_w, self.lambda_b, self.lambda_e)
        opt = adam(self.learning_rate)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                draws = vbpr_draws(epoch_generator(seed, epoch, dev), n, n_batches * bsz,
                                   num_items)
                opt_state, loss_sum = causalrec_epoch(params, opt, opt_state, draws, pairs,
                                                      membership, F, hyper, bsz, self.tanh,
                                                      self.mesh)
            return opt_state, loss_sum

        epoch_loop(self, self.n_epochs, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Epoch %d/%d, loss: %.4f" % (done, self.n_epochs,
                                                    float(loss) / n_batches)))

        self._store(params, F, mean_feat)
        return self

    def _store(self, params, F, mean_feat):
        """The scoring arrays (float64 on the host) from the parameters:
        the visual transformations computed on the features' device."""
        np64 = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
        with torch.no_grad(), full_f32():
            p = {name: t.detach() for name, t in params.items()}
            self.beta_item = np64(p["Bi"])
            self.gamma_user = np64(p["Gu"])
            self.gamma_item = np64(p["Gi"])
            self.theta_user = np64(p["Tu"])
            self.theta_item = np64(visual(p, F, "E", self.tanh))
            self.ind_theta_item = np64(visual(p, F, "E_ind", self.tanh))
            self.visual_bias = np64((F @ p["Bp"]).reshape(-1))
            mean = torch.as_tensor(np.asarray(mean_feat, np.float32), device=F.device)
            self.mean_feat = np64(visual(p, mean, "E_ind", self.tanh))
        self.beta_item_mean = float(self.beta_item.mean())
        self.gamma_item_mean = self.gamma_item.mean(axis=0, keepdims=True)

    def _debiased_scores(self, users):
        """expit(m+n) expit(m) expit(n) - lambda_2 expit(m*+n) expit(m*)
        expit(n), where m* replaces the item branch with its mean."""
        from scipy.special import expit

        gu, tu = self.gamma_user[users], self.theta_user[users]
        m = (self.beta_item[None, :] + gu @ self.gamma_item.T
             + gu @ (self.gamma_item * self.ind_theta_item).T)
        m_star = (self.beta_item_mean + gu @ self.gamma_item_mean.T
                  + gu @ (self.gamma_item_mean * self.mean_feat).T)  # (B, 1)
        nb = self.visual_bias[None, :] + tu @ self.theta_item.T
        return (expit(m + nb) * expit(m) * expit(nb)
                - self.lambda_2 * expit(m_star + nb) * expit(m_star) * expit(nb))

    def score(self, user_idx, item_idx=None):
        if item_idx is not None:
            raise NotImplementedError("The sampled evaluation is not implemented!")
        return self._debiased_scores(np.asarray([user_idx]))[0]

    def score_batch(self, user_indices):
        users = np.clip(np.asarray(user_indices), 0, self.total_users - 1)
        return self._debiased_scores(users).astype(np.float64)
