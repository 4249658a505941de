"""The port's VBPR, AMR, CausalRec, VMF, DMRL and PCRL against the JAX
package's, on the CPU, on ``tests/data/rating.txt`` with seeded 12-wide
item features, a seeded item corpus and a seeded item graph.

- Initial parameters bit for bit (the same numpy draws in the same order).
- One epoch of each on the JAX key's own draws (drawn in the test as the
  JAX fit draws them: VBPR's and CausalRec's positives and negatives,
  VMF's and DMRL's permutation, DMRL's negatives and dropout masks, PCRL's
  Gamma samples and weight noise) against the JAX package's one-epoch fit:
  every parameter within rtol 1e-4 / atol 1e-6 (DMRL, PCRL: atol 1e-5), float32
  rounding that Adam, AdamW and RMSProp carry through the epoch's steps
  (DMRL at the example's lr 0.001: at 0.01, eight AdamW steps carry the
  rounding of the modality MLPs' bias gradients, sums of terms of both
  signs, to 3e-5). DMRL's leaky ReLU has JAX's slope 1 at 0, which a
  dropped input row reaches with the zero initial bias.
- AMR's outer gradient on one minibatch against ``jax.value_and_grad`` of
  the JAX fit's own loss (captured from it, the trace cut short): within
  rtol 1e-4 / atol 1e-7; the perturbation is the sign of the inner
  gradient and carries no gradient.
- PCRL's Gamma sample: fed the JAX sample, the port's gradient with respect
  to alpha within rtol 1e-3 of ``jax.grad`` through ``jax.random.gamma``
  (``torch._standard_gamma_grad`` and JAX's ``random_gamma_grad``
  approximate the implicit derivative differently: within 7.6e-4 of each
  other over 40,000 draws).
- ``score``, ``score_batch``, ``score_pairs`` and ``recommend`` on the same
  parameters, carried across by ``convert.model_from_params`` (rtol 1e-5:
  the projected features are computed on the model's device in float32).
- DMRL's TF-IDF fallback equal to the JAX package's; a ``mesh=`` that is no mesh refused.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
from cornac_tpu.data import Reader
from cornac_tpu.models.dmrl import _dist_corr as j_dist_corr
from cornac_tpu.utils import get_rng as j_get_rng
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models import causalrec as causal_mod, dmrl as dmrl_mod
from cornac_tpu_torch.models import pcrl as pcrl_mod, vbpr as vbpr_mod, vmf as vmf_mod
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.ops.optim import adam, adamw, rmsprop

cornac_tpu_torch.set_default_device("cpu")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rating.txt")
EPOCH = dict(rtol=1e-4, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
SCORES = dict(rtol=1e-5, atol=1e-6)
_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")
WORDS = [f"w{k}" for k in range(40)]


def _modalities(data):
    """Seeded item features (12 wide, non-negative), a seeded corpus of
    3-8 words an item and a seeded item graph."""
    items = sorted({i for _, i, _ in data})
    rng = np.random.RandomState(0)
    feats = rng.rand(len(items), 12).astype(np.float32)
    docs = [" ".join(rng.choice(WORDS, size=rng.randint(3, 9))) for _ in items]
    graph = [(items[a], items[b], 1.0) for a, b in rng.randint(len(items), size=(250, 2))
             if a != b]
    return items, feats, docs, graph


@pytest.fixture(scope="module")
def splits():
    data = Reader().read(DATA, fmt="UIR")
    items, feats, docs, graph = _modalities(data)

    def split(d, e):
        return e.RatioSplit(data=data, test_size=0.2, rating_threshold=3.0, seed=123,
                            exclude_unknowns=True, verbose=False,
                            item_image=d.ImageModality(features=feats, ids=items),
                            item_text=d.TextModality(corpus=docs, ids=items),
                            item_graph=d.GraphModality(data=graph))

    return split(jdata, jeval), split(pdata, peval)


def _key(rng):
    """The JAX fit's key: ``PRNGKey`` of its generator's next draw (after
    the initial parameters' draws, which ``rng`` has made)."""
    return jax.random.PRNGKey(rng.randint(2**31))


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _pairs(train):
    rid, cid, _ = train.uir_tuple
    return torch.from_numpy(np.stack([rid, cid], 1).astype(np.int64))


# ------------------------------------------------------- VBPR and AMR --

VBPR_KW = dict(k=4, k2=3, batch_size=16, learning_rate=0.01, lambda_w=0.1, lambda_b=0.01,
               lambda_e=0.01, verbose=False)


def _bpr_draws(key, epoch, n, n_total, num_items):
    k_pos, k_neg = jax.random.split(jax.random.fold_in(key, epoch))
    return (_t(jax.random.randint(k_pos, (n_total,), 0, n), torch.int64),
            _t(jax.random.randint(k_neg, (n_total,), 0, num_items), torch.int64))


@pytest.mark.parametrize("name", ["VBPR", "AMR"])
def test_vbpr_initial_parameters_are_the_jax_packages(splits, name):
    js, ps = splits
    jm = getattr(J, name)(seed=3, trainable=False, **VBPR_KW).fit(js.train_set)
    pm = getattr(P, name)(seed=3, trainable=False, **VBPR_KW).fit(ps.train_set)
    for a, b in zip(pm._arrays(), (jm.beta_item, jm.gamma_user, jm.gamma_item, jm.theta_user,
                                   jm.emb_matrix, jm.beta_prime)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pm.theta_item, jm.theta_item, **SCORES)
    np.testing.assert_allclose(pm.visual_bias, jm.visual_bias, **SCORES)


@pytest.mark.parametrize("name", ["VBPR", "AMR"])
def test_one_vbpr_epoch_on_the_jax_draws_matches_the_jax_fit(splits, name):
    js, ps = splits
    jm = getattr(J, name)(seed=3, n_epochs=1, **VBPR_KW).fit(js.train_set)
    pm = getattr(P, name)(seed=3, trainable=False, **VBPR_KW).fit(ps.train_set)
    train = ps.train_set
    n, bsz = train.num_ratings, VBPR_KW["batch_size"]
    n_total = -(-n // bsz) * bsz
    params = {t: torch.tensor(np.asarray(a, np.float32), requires_grad=True)
              for t, a in zip(vbpr_mod.TABLES, pm._arrays())}
    F = torch.from_numpy(np.asarray(train.item_image.features[: pm.total_items], np.float32))
    opt = adam(VBPR_KW["learning_rate"])
    hyper = (pm.lambda_w, pm.lambda_b, pm.lambda_e, pm._adv_lambda, pm._adv_epsilon)
    vbpr_mod.vbpr_epoch(params, opt, opt.init(params),
                        _bpr_draws(_key(j_get_rng(3)), 0, n, n_total, train.num_items),
                        _pairs(train), F, hyper,
                        bsz, pm._adversarial)
    for t, want in zip(vbpr_mod.TABLES, (jm.beta_item, jm.gamma_user, jm.gamma_item,
                                         jm.theta_user, jm.emb_matrix, jm.beta_prime)):
        np.testing.assert_allclose(params[t].detach().numpy(), want, **EPOCH, err_msg=t)


class _Captured(Exception):
    pass


def _jax_loss_fn(monkeypatch, make, train_set):
    """The JAX fit's own loss function: the one it hands
    ``jax.value_and_grad`` while tracing its epoch (the trace is then cut
    short, so nothing compiles)."""
    fns = []

    def capture(fun, *args, **kwargs):
        fns.append(fun)
        raise _Captured

    with monkeypatch.context() as patch:
        patch.setattr(jax, "value_and_grad", capture)
        with pytest.raises(_Captured):
            make().fit(train_set)
    return fns[0]


def test_amr_outer_gradient_is_the_jax_packages(splits, monkeypatch):
    js, ps = splits
    kw = dict(VBPR_KW, n_epochs=1, epsilon_adv=0.5, lambda_adv=2.0)
    loss_fn = _jax_loss_fn(monkeypatch, lambda: J.AMR(seed=5, **kw), js.train_set)
    pm = P.AMR(seed=5, trainable=False, **kw).fit(ps.train_set)
    train = ps.train_set
    rng = np.random.RandomState(1)
    rid, cid, _ = train.uir_tuple
    idx = rng.randint(len(rid), size=32)
    u, i, j = rid[idx], cid[idx], rng.randint(train.num_items, size=32)
    arrays = dict(zip(vbpr_mod.TABLES, (np.asarray(a, np.float32) for a in pm._arrays())))
    j_val, j_grads = jax.value_and_grad(loss_fn)({t: jnp.asarray(a) for t, a in arrays.items()},
                                                 jnp.asarray(u), jnp.asarray(i), jnp.asarray(j))
    params = {t: torch.tensor(a, requires_grad=True) for t, a in arrays.items()}
    F = torch.from_numpy(np.asarray(train.item_image.features[: pm.total_items], np.float32))
    hyper = (pm.lambda_w, pm.lambda_b, pm.lambda_e, pm._adv_lambda, pm._adv_epsilon)
    loss = vbpr_mod.vbpr_loss(params, F, _t(u, torch.int64), _t(i, torch.int64),
                              _t(j, torch.int64), hyper, True)
    plain = vbpr_mod.vbpr_loss(params, F, _t(u, torch.int64), _t(i, torch.int64),
                               _t(j, torch.int64), hyper, False)
    assert float(loss) > float(plain)  # the perturbation raises the loss
    np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.values()))
    for t, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[t]), rtol=1e-4, atol=1e-7,
                                   err_msg=t)


# ------------------------------------------------------------ CausalRec --

CAUSAL_KW = dict(k=4, k2=3, batch_size=16, learning_rate=0.01, lambda_w=0.1, lambda_b=0.01,
                 lambda_e=0.01, verbose=False)


@pytest.mark.parametrize("tanh", [0, 1, 2])
def test_one_causalrec_epoch_on_the_jax_draws_matches_the_jax_fit(splits, tanh):
    js, ps = splits
    kw = dict(CAUSAL_KW, tanh=tanh)
    jm = J.CausalRec(seed=4, n_epochs=1, **kw).fit(js.train_set)
    j0 = J.CausalRec(seed=4, trainable=False, **kw).fit(js.train_set)
    pm = P.CausalRec(seed=4, trainable=False, **kw).fit(ps.train_set)
    train = ps.train_set
    F = torch.from_numpy(np.asarray(train.item_image.features[: pm.total_items], np.float32))
    rng = j_get_rng(4)
    params = {t: torch.tensor(a, requires_grad=True) for t, a in pm._initial(
        F.shape[1], rng).items()}
    for t, want in (("Gu", j0.gamma_user), ("Gi", j0.gamma_item), ("Bi", j0.beta_item)):
        np.testing.assert_array_equal(params[t].detach().numpy(), want)  # the same init
    n, bsz = train.num_ratings, kw["batch_size"]
    n_total = -(-n // bsz) * bsz
    opt = adam(kw["learning_rate"])
    membership = build_membership(train.csr_matrix, device="cpu")
    causal_mod.causalrec_epoch(params, opt, opt.init(params),
                               _bpr_draws(_key(rng), 0, n, n_total, train.num_items), _pairs(train),
                               membership, F, (pm.lambda_w, pm.lambda_b, pm.lambda_e), bsz, tanh)
    pm._store(params, F, F.numpy().mean(axis=0).reshape(1, -1))
    for att in ("beta_item", "gamma_user", "gamma_item", "theta_user", "theta_item",
                "ind_theta_item", "visual_bias", "mean_feat"):
        np.testing.assert_allclose(getattr(pm, att), getattr(jm, att), **EPOCH, err_msg=att)
    users = np.arange(jm.total_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------------------ VMF --

VMF_KW = dict(k=4, d=3, batch_size=16, learning_rate=0.01, verbose=False)


def test_one_vmf_epoch_on_the_jax_order_matches_the_jax_fit(splits):
    js, ps = splits
    jm = J.VMF(seed=6, n_epochs=1, **VMF_KW).fit(js.train_set)
    j0 = J.VMF(seed=6, trainable=False, **VMF_KW).fit(js.train_set)
    pm = P.VMF(seed=6, trainable=False, **VMF_KW).fit(ps.train_set)
    for t in vmf_mod.TABLES:
        np.testing.assert_array_equal(getattr(pm, t), getattr(j0, t))  # the same init
    train = ps.train_set
    n, bsz = train.num_ratings, VMF_KW["batch_size"]
    n_total = -(-n // bsz) * bsz
    rng = j_get_rng(6)
    for t in vmf_mod.TABLES:
        rng.randn(*getattr(pm, t).shape)  # the initial draws
    order = _t(jax.random.permutation(jax.random.fold_in(_key(rng), 0), n_total) % n,
               torch.int64)
    params = {t: torch.tensor(getattr(pm, t).astype(np.float32), requires_grad=True)
              for t in vmf_mod.TABLES}
    rid, cid, rat = train.uir_tuple
    rat = (rat.astype(np.float32) - pm.min_rating) / (pm.max_rating - pm.min_rating)
    F = torch.from_numpy(np.asarray(train.item_image.features[: pm.num_items], np.float32))
    opt = rmsprop(VMF_KW["learning_rate"], decay=pm.gamma)
    vmf_mod.vmf_epoch(params, opt, opt.init(params), order, (_pairs(train), _t(rat)), F,
                      (pm.lambda_u, pm.lambda_v, pm.lambda_p, pm.lambda_e), bsz)
    for t in vmf_mod.TABLES:
        np.testing.assert_allclose(params[t].detach().numpy(), getattr(jm, t), **EPOCH,
                                   err_msg=t)


# ----------------------------------------------------------------- DMRL --

DMRL_KW = dict(batch_size=16, learning_rate=0.001, embedding_dim=8, num_factors=2, num_neg=3,
               decay_c=0.5, decay_r=0.01)


def _flat(tree):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update({f"{name}.{k}": np.asarray(v) for k, v in value.items()})
        else:
            out[name] = np.asarray(value)
    return out


def _dmrl_jax_draws(model, step_key, B, text_dim, image_dim):
    """The draws of one step of the JAX fit, as ``DMRL.draws`` gives them."""
    S, D, F = 1 + model.num_neg, model.embedding_dim, model.num_factors
    neg = _t(jax.random.randint(jax.random.fold_in(step_key, 7), (B, model.num_neg), 0,
                                model.num_items), torch.int64)
    if model.dropout <= 0:
        return neg, None
    keep = 1.0 - model.dropout

    def mask(key, shape):
        return _t(jax.random.bernoulli(key, keep, shape)).to(torch.float32)

    masks = {}
    for name, fold, dim in (("text_mlp", 11, text_dim), ("image_mlp", 13, image_dim)):
        key = jax.random.fold_in(step_key, fold)
        masks[name + "0"] = mask(jax.random.fold_in(key, 0), (B, S, dim))
        masks[name + "1"] = mask(jax.random.fold_in(key, 1), (B, S, dmrl_mod.HIDDEN))
    masks["att"] = mask(jax.random.fold_in(step_key, 17), (B, S, F, 4 * (D // F)))
    return neg, masks


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_one_dmrl_epoch_on_the_jax_draws_matches_the_jax_fit(splits, dropout):
    js, ps = splits
    kw = dict(DMRL_KW, dropout=dropout)
    jm = J.DMRL(seed=7, epochs=1, **kw).fit(js.train_set)
    pm = P.DMRL(seed=7, epochs=0, **kw).fit(ps.train_set)
    train = ps.train_set
    text, image = pm._item_features(train)
    rng = j_get_rng(7)
    params = {t: torch.tensor(a, requires_grad=True)
              for t, a in pm._initial(rng, text, image).items()}
    n, bsz = train.num_ratings, kw["batch_size"]
    n_total = n + (-n) % bsz
    ekey = jax.random.fold_in(_key(rng), 0)
    order = _t(jax.random.permutation(ekey, n_total) % n, torch.int64)
    steps = iter(range(n_total // bsz))
    opt = adamw(kw["learning_rate"], b1=0.9, b2=0.999, weight_decay=kw["decay_r"])
    pm.epoch(params, opt, opt.init(params), order, _pairs(train),
             lambda B: _dmrl_jax_draws(pm, jax.random.fold_in(ekey, next(steps)), B,
                                       text.shape[1], image.shape[1]), bsz)
    want = _flat(jm.params)
    assert set(want) == set(params)
    for t, value in params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[t], **LOOSE, err_msg=t)


def test_dmrl_scores_text_fallback_and_distance_correlation(splits):
    js, ps = splits
    jm = J.DMRL(seed=8, epochs=2, **DMRL_KW).fit(js.train_set)
    pm = model_from_params("DMRL", jm.params, {**{n: getattr(jm, n) for n in _SNAPSHOT},
                                               **{n: DMRL_KW[n] for n in (
                                                   "embedding_dim", "num_factors", "num_neg")}},
                           device="cpu", train_set=ps.train_set)
    for ours, theirs in zip(pm._item_features(ps.train_set), jm._item_features(js.train_set)):
        np.testing.assert_array_equal(ours, theirs)  # TF-IDF over the count matrix, the image
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **SCORES)
    np.testing.assert_allclose(pm.score(2, 5), jm.score(2, 5), **SCORES)
    raw = list(jm.uid_map)[:5]
    assert pm.recommend_batch(raw, k=4) == jm.recommend_batch(raw, k=4)
    rng = np.random.RandomState(2)
    X, Y = rng.randn(9, 4).astype(np.float32), rng.randn(9, 4).astype(np.float32)
    np.testing.assert_allclose(float(dmrl_mod.dist_corr_pairs(torch.stack([_t(X), _t(Y)],
                                                                            1)[None])),
                               float(j_dist_corr(jnp.asarray(X[None]), jnp.asarray(Y[None]))[0]),
                               rtol=1e-5)


# ----------------------------------------------------------------- PCRL --

PCRL_KW = dict(k=4, z_dims=[6], batch_size=8, learning_rate=0.01)


def test_pcrl_gamma_gradient_is_the_jax_packages():
    rng = np.random.RandomState(3)
    alpha = (0.3 + 3 * rng.rand(5, 7)).astype(np.float32)
    w = rng.randn(5, 7).astype(np.float32)
    key = jax.random.PRNGKey(9)
    sample = jax.random.gamma(key, jnp.asarray(alpha))
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jax.random.gamma(key, a)))(
        jnp.asarray(alpha))
    a = torch.tensor(alpha, requires_grad=True)
    z = pcrl_mod.ReparamGamma.apply(a, _t(sample))
    (got,) = torch.autograd.grad((z * _t(w)).sum(), [a])
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(sample))
    # the two libraries approximate the implicit derivative differently:
    # over 40,000 draws at alpha in [0.3, 5.3] they agree within 7.6e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-6)
    # the sampler's own draws carry the same gradient
    drawn = torch._standard_gamma(a.detach(), generator=torch.Generator().manual_seed(0))
    z2 = torch.distributions.Gamma(a, torch.ones_like(a)).rsample()
    assert z2.requires_grad and drawn.shape == a.shape


def _pcrl_jax_draws(step_key, params, w_determinist):
    """The draws of one step of the JAX fit, as ``pcrl_epoch`` takes them:
    the Gamma sample ``jax.random.gamma`` makes from the step's key at the
    port's alpha, and the weight noise."""
    def draw(alpha):
        return _t(jax.random.gamma(step_key, jnp.asarray(alpha.detach().numpy())))

    noise = None
    if not w_determinist:
        k2 = jax.random.fold_in(step_key, 2**31)
        noise = [_t(jax.random.normal(jax.random.fold_in(k2, l), W.shape))
                 for l, W in enumerate(pcrl_mod._layers(params, "gen"))]
    return draw, noise


@pytest.mark.parametrize("w_determinist", [True, False])
def test_one_pcrl_epoch_on_the_jax_draws_matches_the_jax_fit(splits, w_determinist):
    js, ps = splits
    kw = dict(PCRL_KW, w_determinist=w_determinist)
    jm = J.PCRL(seed=9, max_iter=1, **kw).fit(js.train_set)
    train = ps.train_set
    rng = j_get_rng(9)
    d, k = train.num_items, kw["k"]
    tables = tuple(torch.from_numpy(rng.gamma(50, scale=0.3 / 50, size=(rows, k)).astype(
        np.float32)) for rows in (train.num_users, train.num_users, d, d))
    C_np = np.asarray(train.item_graph.matrix[:d, :d].todense(), np.float32)
    params = {t: torch.tensor(W, requires_grad=True) for t, W in pcrl_mod.flat_params(
        pcrl_mod.init_nets(rng, C_np.shape[1], kw["z_dims"], k)).items()}
    bsz = kw["batch_size"]
    C = torch.from_numpy(np.concatenate([C_np, np.zeros(((-d) % bsz, d), np.float32)]))
    rid, cid, val = train.uir_tuple
    ratings = (_t(rid, torch.int64), _t(cid, torch.int64), _t(val, torch.float32))
    ekey = jax.random.fold_in(_key(rng), 0)
    opt = rmsprop(kw["learning_rate"])
    _, tables, _ = pcrl_mod.pcrl_epoch(
        params, opt, opt.init(params), tables, ratings, C, bsz,
        lambda b: _pcrl_jax_draws(jax.random.fold_in(ekey, b), params, w_determinist))
    G_s, G_r, _, _ = pcrl_mod.pf_sweep(*tables, *ratings)
    for got, want in ((G_s, jm.Gs), (G_r, jm.Gr), (tables[2], jm.Ls), (tables[3], jm.Lr)):
        np.testing.assert_allclose(got.numpy(), want, **LOOSE)
    want = pcrl_mod.flat_params({side: [np.asarray(W) for W in jm.params[side]]
                                 for side in ("inf", "gen")})
    for t, value in params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[t], **LOOSE, err_msg=t)


# ------------------------------------------------------ scores, refusals --


def _scores_match(pm, jm, item_scores=True):
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **SCORES)
    for u in (0, jm.num_users - 1):
        np.testing.assert_allclose(pm.score(u), jm.score(u), **SCORES)
        if item_scores:
            np.testing.assert_allclose(pm.score(u, 3), jm.score(u, 3), **SCORES)
    raw = list(jm.uid_map)[:6]
    for k in (5, -1):
        assert pm.recommend_batch(raw, k=k) == jm.recommend_batch(raw, k=k)


@pytest.mark.parametrize("name", ["VBPR", "AMR", "CausalRec", "VMF", "PCRL"])
def test_scores_through_convert_match_jax(splits, name):
    js, ps = splits
    if name == "PCRL":
        jm = J.PCRL(seed=2, max_iter=3, **PCRL_KW).fit(js.train_set)
        params = {"G_s": jm.Gs, "G_r": jm.Gr, "L_s": jm.Ls, "L_r": jm.Lr}
        options = {"k": jm.k, "z_dims": jm.z_dims}
    elif name == "VMF":
        jm = J.VMF(seed=2, n_epochs=2, **VMF_KW).fit(js.train_set)
        params = {t: getattr(jm, t) for t in vmf_mod.TABLES}
        options = {"k": jm.k, "d": jm.d}
    elif name == "CausalRec":
        jm = J.CausalRec(seed=2, n_epochs=2, tanh=2, **CAUSAL_KW).fit(js.train_set)
        captured = {}
        real = J.CausalRec._store
        J.CausalRec._store = lambda self, p, F, m: captured.update(p) or real(self, p, F, m)
        try:
            jm = J.CausalRec(seed=2, n_epochs=2, tanh=2, **CAUSAL_KW).fit(js.train_set)
        finally:
            J.CausalRec._store = real
        params = {t: np.asarray(a) for t, a in captured.items()}
        options = {"k": jm.k, "k2": jm.k2, "tanh": 2, "lambda_2": jm.lambda_2}
    else:
        jm = getattr(J, name)(seed=2, n_epochs=2, **VBPR_KW).fit(js.train_set)
        params = dict(zip(vbpr_mod.TABLES, (jm.beta_item, jm.gamma_user, jm.gamma_item,
                                            jm.theta_user, jm.emb_matrix, jm.beta_prime)))
        options = {"k": jm.k, "k2": jm.k2}
    meta = {**{n: getattr(jm, n) for n in _SNAPSHOT}, **options}
    pm = model_from_params(name, params, meta, device="cpu", train_set=ps.train_set)
    _scores_match(pm, jm, item_scores=name != "CausalRec")
    if name in ("VBPR", "AMR", "PCRL"):
        np.testing.assert_allclose(pm.get_item_vectors(), jm.get_item_vectors(), **SCORES)
        rows = np.arange(jm.num_users)
        items = np.arange(jm.num_users) % jm.num_items
        np.testing.assert_allclose(pm.score_pairs(rows, items), jm.score_pairs(rows, items),
                                   **SCORES)


@pytest.mark.parametrize("cls", [P.VBPR, P.AMR, P.CausalRec, P.VMF, P.DMRL, P.PCRL])
def test_mesh_is_refused(cls):
    # mesh= is ported (tests/test_torch_parallel_side.py): anything but a
    # parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        cls(mesh=object())
