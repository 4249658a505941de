"""The port's VAECF, RecVAE and BiVAECF against the JAX package's, on the CPU.

- Initial parameters: bit for bit from the same ``get_rng`` seed.
- One loss and its gradients on the same batch and the same noise (drawn
  in the test from a JAX key, as the JAX loss draws it, and handed to the
  port's loss), then one Adam step, within rtol 1e-5 / atol 1e-6.
- VAECF's three data modes (resident, index-resident, streamed) give the
  same bits in the port (the constants monkeypatched as
  ``tests/test_neural_models.py`` does for the JAX package).
- Scoring on the same parameters: ``score``, ``score_batch``,
  ``score_pairs`` (and BiVAECF's ``recommend_batch``) within rtol 1e-5 /
  atol 1e-6 of the JAX package's.
- VAECF's ``recommend_batch(k > 0)`` ranks the encoder means against the
  decoder's last weight: both packages raise where the latent width k
  differs from the first hidden width, and agree where they are equal.
- BiVAECF's constrained adaptive priors: the prior maps drawn bit for bit
  after both encoders, one loss and its gradients with the priors' means
  on the JAX package's noise within rtol 1e-5 / atol 1e-6, and a short
  fit that, like the JAX package's, leaves the maps as drawn.
- Refusals: ``mesh=`` (ROADMAP.md A8).
- Short fits: a seeded fit twice (once verbose) gives the same bits.

Whole fits are held on quality on the card (``chip_smoke.py``): the random
streams of the two packages differ.
"""

import contextlib
import io

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.engine.nn import ACTIVATIONS as J_ACT
from cornac_tpu.models import BiVAECF as JBiVAECF, RecVAE as JRecVAE, VAECF as JVAECF
from cornac_tpu.models import bivaecf as j_bivae, recvae as j_recvae, vaecf as j_vaecf
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu_torch.convert import params_to_module
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.engine.nn import ACTIVATIONS
from cornac_tpu_torch.models import BiVAECF, RecVAE, VAECF
from cornac_tpu_torch.models import bivaecf as bivae_mod, recvae as recvae_mod
from cornac_tpu_torch.models import vaecf as vaecf_mod
from cornac_tpu_torch.ops.optim import adam, step
from cornac_tpu_torch.utils import get_rng

from test_torch_nn import flatten

cornac_tpu_torch.set_default_device("cpu")

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(seed=4, n_users=40, n_items=50, n=500):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]


def _both(data=None):
    data = _data() if data is None else data
    return JDataset.from_uir(data, seed=1), Dataset.from_uir(data, seed=1)


def _batch(bsz, dim, seed=0):
    return (np.random.RandomState(seed).rand(bsz, dim) < 0.3).astype(np.float32)


def _assert_tree_equal(module, tree, exact=True):
    want = flatten(tree)
    got = {n: p.detach().numpy() for n, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        if exact:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)


def _grads(loss, module):
    params = dict(module.named_parameters())
    return dict(zip(params, (g.numpy() for g in torch.autograd.grad(loss, list(params.values())))))


def _assert_grads(got, tree):
    want = flatten(tree)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)


def _adam_step_matches(module, tree, j_grads, loss, lr=0.01):
    opt = optax.adam(lr)
    updates, _ = opt.update(j_grads, opt.init(tree), tree)
    params = dict(module.named_parameters())
    t_opt = adam(lr)
    step(params, t_opt, t_opt.init(params), loss)
    _assert_tree_equal(module, optax.apply_updates(tree, updates), exact=False)


# ---------------------------------------------------------------- VAECF --
@pytest.mark.parametrize("likelihood", ["mult", "bern", "gaus", "pois"])
def test_vaecf_init_loss_grads_and_adam_step(likelihood, k=4, dim=30, bsz=12):
    struct = [dim, 10, 6]
    tree = j_vaecf._init_vae(j_get_rng(9), k, struct)
    vae = vaecf_mod._init_vae(get_rng(9), k, struct)
    _assert_tree_equal(vae, tree)

    x = _batch(bsz, dim)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (bsz, k)))
    loss, j_grads = jax.value_and_grad(j_vaecf._vae_loss)(
        tree, jnp.asarray(x), key, J_ACT["tanh"], likelihood, 0.7)
    ours = vaecf_mod._vae_loss(vae, torch.from_numpy(x), torch.from_numpy(noise),
                               ACTIVATIONS["tanh"], likelihood, 0.7)
    np.testing.assert_allclose(float(ours), float(loss), **TOL)
    _assert_grads(_grads(ours, vae), j_grads)
    _adam_step_matches(vae, tree, j_grads, vaecf_mod._vae_loss(
        vae, torch.from_numpy(x), torch.from_numpy(noise), ACTIVATIONS["tanh"], likelihood, 0.7))


def _vaecf(**kw):
    return dict(k=4, autoencoder_structure=[8], n_epochs=3, batch_size=8, seed=11, **kw)


def test_vaecf_three_data_modes_give_the_same_bits(monkeypatch):
    _, train = _both()
    fits = {}
    for mode, resident, sparse in (("resident", None, None), ("index-resident", 0, None),
                                   ("streamed", 0, 0)):
        if resident is not None:
            monkeypatch.setattr(vaecf_mod, "_RESIDENT_BYTES", resident)
        if sparse is not None:
            monkeypatch.setattr(vaecf_mod, "_SPARSE_RESIDENT_BYTES", sparse)
        model = VAECF(**_vaecf()).fit(train)
        assert model.data_mode == mode
        fits[mode] = {n: p.detach().numpy() for n, p in model.params.named_parameters()}
    for mode in ("index-resident", "streamed"):
        for n, p in fits["resident"].items():
            np.testing.assert_array_equal(fits[mode][n], p, err_msg=f"{mode} {n}")


def test_vaecf_seeded_fits_are_identical_and_chunking_free():
    _, train = _both()
    a = VAECF(**_vaecf()).fit(train)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        b = VAECF(**_vaecf(verbose=True)).fit(train)
    assert out.getvalue().count("Epoch") == 3
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)


def test_vaecf_scores_match_jax_on_the_same_parameters():
    jtrain, train = _both()
    theirs = JVAECF(**_vaecf()).fit(jtrain)
    ours = VAECF(**{**_vaecf(), "n_epochs": 0}).fit(train)
    ours.params = params_to_module(theirs.params, device="cpu")
    users = np.array([0, 3, 7, 3, 39])
    np.testing.assert_allclose(ours.score(5), theirs.score(5), **TOL)
    assert np.isclose(ours.score(5, 7), theirs.score(5, 7), **TOL)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users), **TOL)
    items = np.array([1, 4, 9, 0, 49])
    np.testing.assert_allclose(ours.score_pairs(users, items), theirs.score_pairs(users, items),
                               **TOL)
    np.testing.assert_allclose(ours.score_batch_device(users).numpy(),
                               np.asarray(theirs.score_batch_device(users)), **TOL)
    np.testing.assert_allclose(ours.get_user_vectors(), theirs.get_user_vectors(), **TOL)
    np.testing.assert_array_equal(ours.get_item_vectors(), theirs.get_item_vectors())


@pytest.mark.parametrize("k,hidden", [(4, 8), (6, 6)])
def test_vaecf_recommend_batch_raises_unless_k_is_the_hidden_width(k, hidden):
    jtrain, train = _both()
    kw = dict(k=k, autoencoder_structure=[hidden], n_epochs=2, batch_size=8, seed=11)
    theirs = JVAECF(**kw).fit(jtrain)
    ours = VAECF(**{**kw, "n_epochs": 0}).fit(train)
    ours.params = params_to_module(theirs.params, device="cpu")
    uids = list(train.uid_map)[:5]
    if k != hidden:
        with pytest.raises(TypeError):
            theirs.recommend_batch(uids, k=3)
        with pytest.raises(ValueError):
            ours.recommend_batch(uids, k=3)
    else:
        assert ours.recommend_batch(uids, k=3) == theirs.recommend_batch(uids, k=3)
    # one user at a time ranks the decoded scores in both packages
    assert ours.recommend(uids[0], k=5) == theirs.recommend(uids[0], k=5)


# --------------------------------------------------------------- RecVAE --
@pytest.mark.parametrize("gamma,beta,dropout", [(0.005, None, 0.5), (0.0, 0.2, 0.0)])
def test_recvae_init_loss_grads_and_adam_step(gamma, beta, dropout, dim=30, bsz=10):
    hidden, latent = 12, 5
    rng = j_get_rng(2)
    j_enc = j_recvae._init_encoder(rng, dim, hidden, latent)
    j_dec = j_recvae.init_dense(rng, latent, dim)
    rng = get_rng(2)
    enc = recvae_mod._init_encoder(rng, dim, hidden, latent)
    dec = recvae_mod.init_dense(rng, latent, dim)
    _assert_tree_equal(enc, j_enc)
    _assert_tree_equal(dec, j_dec)

    # the old posterior: other parameters of the same shapes
    j_old = j_recvae._init_encoder(j_get_rng(5), dim, hidden, latent)
    old = params_to_module(j_old, device="cpu")
    x = _batch(bsz, dim, seed=1)
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0), 1.0 - dropout, x.shape))
    noise = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (bsz, latent)))
    model = JRecVAE(gamma=gamma, beta=beta)
    loss, (g_enc, g_dec) = jax.value_and_grad(
        lambda e, d: model._loss(e, d, j_old, jnp.asarray(x), key, dropout), argnums=(0, 1))(
        j_enc, j_dec)

    def ours():
        return recvae_mod._recvae_loss(enc, dec, old, torch.from_numpy(x), torch.from_numpy(keep),
                                       torch.from_numpy(noise), dropout, gamma, beta)

    value = ours()
    np.testing.assert_allclose(float(value), float(loss), **TOL)
    _assert_grads(_grads(value, enc), g_enc)
    _assert_grads(_grads(ours(), dec), g_dec)
    _adam_step_matches(enc, j_enc, g_enc, ours())


def test_recvae_seeded_fits_are_identical_and_score_as_jax():
    jtrain, train = _both()
    kw = dict(hidden_dim=12, latent_dim=5, batch_size=8, n_epochs=2, seed=3)
    a = RecVAE(**kw).fit(train)
    with contextlib.redirect_stdout(io.StringIO()):
        b = RecVAE(**kw, verbose=True).fit(train)
    for side in ("enc", "dec"):
        for (n, p), q in zip(getattr(a, side).named_parameters(), getattr(b, side).parameters()):
            np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)
    theirs = JRecVAE(**kw).fit(jtrain)
    a.enc = params_to_module(theirs.enc, device="cpu")
    a.dec = params_to_module(theirs.dec, device="cpu")
    users, items = np.array([0, 2, 2, 39]), np.array([3, 3, 8, 49])
    np.testing.assert_allclose(a.score(4), theirs.score(4), **TOL)
    np.testing.assert_allclose(a.score_batch(users), theirs.score_batch(users), **TOL)
    np.testing.assert_allclose(a.score_pairs(users, items), theirs.score_pairs(users, items),
                               **TOL)


# -------------------------------------------------------------- BiVAECF --
@pytest.mark.parametrize("likelihood", ["bern", "gaus", "pois"])
def test_bivaecf_init_loss_grads_and_adam_step(likelihood, k=4, bsz=8):
    jtrain, train = _both()
    n_users, n_items = train.num_users, train.num_items
    rng = j_get_rng(6)
    j_user = j_bivae._init_side(rng, [n_items, 10], k)
    j_item = j_bivae._init_side(rng, [n_users, 10], k)
    theta = rng.normal(0, 0.01, (n_users, k)).astype(np.float32)
    rng = get_rng(6)
    user = bivae_mod._init_side(rng, [n_items, 10], k)
    item = bivae_mod._init_side(rng, [n_users, 10], k)
    np.testing.assert_array_equal(rng.normal(0, 0.01, (n_users, k)).astype(np.float32), theta)
    _assert_tree_equal(user, j_user)
    _assert_tree_equal(item, j_item)

    x = _batch(bsz, n_users, seed=2)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (bsz, k)))
    loss, j_grads = jax.value_and_grad(j_bivae._side_loss)(
        j_item, jnp.asarray(x), jnp.asarray(theta), key, J_ACT["tanh"], likelihood, 1.0, 0.0)

    def ours():
        return bivae_mod._side_loss(item, torch.from_numpy(x), torch.from_numpy(theta),
                                    torch.from_numpy(noise), ACTIVATIONS["tanh"], likelihood, 1.0)

    value = ours()
    np.testing.assert_allclose(float(value), float(loss), **TOL)
    _assert_grads(_grads(value, item), j_grads)
    _adam_step_matches(item, j_item, j_grads, ours())


def test_bivaecf_seeded_fits_are_identical_and_score_as_jax():
    jtrain, train = _both()
    kw = dict(k=4, encoder_structure=[10], batch_size=16, n_epochs=2, seed=5)
    a = BiVAECF(**kw).fit(train)
    with contextlib.redirect_stdout(io.StringIO()):
        b = BiVAECF(**kw, verbose=True).fit(train)
    np.testing.assert_array_equal(a.mu_theta, b.mu_theta)
    np.testing.assert_array_equal(a.mu_beta, b.mu_beta)
    assert a.mu_theta.shape == (train.num_users, 4) and np.abs(a.mu_beta).sum() > 0
    theirs = JBiVAECF(**kw).fit(jtrain)
    a.mu_theta, a.mu_beta = theirs.mu_theta, theirs.mu_beta
    users, items = np.array([0, 2, 2, 39]), np.array([3, 3, 8, 49])
    np.testing.assert_allclose(a.score(4), theirs.score(4), **TOL)
    assert np.isclose(a.score(4, 2), theirs.score(4, 2), **TOL)
    np.testing.assert_allclose(a.score_batch(users), theirs.score_batch(users), **TOL)
    np.testing.assert_allclose(a.score_pairs(users, items), theirs.score_pairs(users, items),
                               **TOL)
    np.testing.assert_allclose(a.score_batch_device(users).numpy(),
                               np.asarray(theirs.score_batch_device(users)), **TOL)
    uids = list(train.uid_map)[:6]
    assert a.recommend_batch(uids, k=5) == theirs.recommend_batch(uids, k=5)
    assert (a.recommend_batch(uids, k=5, remove_seen=True, train_set=train)
            == theirs.recommend_batch(uids, k=5, remove_seen=True, train_set=jtrain))


def test_bivaecf_constrained_priors_match_jax():
    from cornac_tpu.data import FeatureModality as JFeatureModality
    from cornac_tpu_torch.data import FeatureModality

    jtrain, train = _both()
    rng = np.random.RandomState(9)
    feats = {"user_feature": rng.rand(train.num_users, 5).astype(np.float32),
             "item_feature": rng.rand(train.num_items, 3).astype(np.float32)}
    for attr, F in feats.items():
        setattr(jtrain, attr, JFeatureModality(features=F))
        setattr(train, attr, FeatureModality(features=F))
    kw = dict(k=4, encoder_structure=[10], batch_size=16, seed=5,
              cap_priors={"user": True, "item": True})
    theirs = JBiVAECF(n_epochs=0, **kw).fit(jtrain)
    ours = BiVAECF(n_epochs=0, **kw).fit(train)
    _assert_tree_equal(ours.user_side, theirs.user_side)
    _assert_tree_equal(ours.item_side, theirs.item_side)

    # one loss and its gradients, the means centred on the prior map
    x = _batch(16, train.num_users, seed=2)
    f = feats["item_feature"][:16]
    theta = np.random.RandomState(3).normal(0, 0.1, (train.num_users, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (16, 4)))
    mu_prior = j_bivae.dense(theirs.item_side["prior"], jnp.asarray(f))
    loss, j_grads = jax.value_and_grad(j_bivae._side_loss)(
        theirs.item_side, jnp.asarray(x), jnp.asarray(theta), key, J_ACT["tanh"], "pois", 1.0,
        mu_prior)
    with torch.no_grad():
        p_prior = ours.item_side.prior(torch.from_numpy(f))
    value = bivae_mod._side_loss(ours.item_side, torch.from_numpy(x), torch.from_numpy(theta),
                                 torch.from_numpy(noise), ACTIVATIONS["tanh"], "pois", 1.0,
                                 p_prior)
    np.testing.assert_allclose(float(value), float(loss), **TOL)
    trained = bivae_mod._trained(ours.item_side)
    grads = dict(zip(trained, (g.numpy() for g in torch.autograd.grad(
        value, list(trained.values())))))
    j_flat = flatten(j_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, j_flat[name], **TOL, err_msg=name)
    # the JAX package's gradient of the prior map is zero: it is not trained
    assert {n for n in j_flat if n.startswith("prior.")} == {"prior.w", "prior.b"}
    assert all(not np.any(j_flat[n]) for n in j_flat if n.startswith("prior."))

    # a short fit moves the encoders and leaves the prior maps as drawn, in
    # both packages; a seeded refit gives the same bits
    fitted = BiVAECF(n_epochs=2, **kw).fit(train)
    again = BiVAECF(n_epochs=2, **kw).fit(train)
    j_fitted = JBiVAECF(n_epochs=2, **kw).fit(jtrain)
    for side in ("user_side", "item_side"):
        prior = {n: p.detach().numpy() for n, p in getattr(fitted, side).named_parameters()
                 if n.startswith("prior.")}
        j_prior = {n: v for n, v in flatten(getattr(j_fitted, side)).items()
                   if n.startswith("prior.")}
        assert prior.keys() == j_prior.keys() and prior
        for n in prior:
            np.testing.assert_array_equal(prior[n], j_prior[n], err_msg=n)
    np.testing.assert_array_equal(fitted.mu_theta, again.mu_theta)
    assert np.abs(fitted.mu_theta).sum() > 0


def test_refusals_name_their_roadmap_items():
    for make in (lambda: VAECF(mesh=object()), lambda: RecVAE(mesh=object()),
                 lambda: BiVAECF(mesh=object())):
        with pytest.raises(NotImplementedError, match="A8"):
            make()
    with pytest.raises(ValueError):
        VAECF(likelihood="nope")
    with pytest.raises(ValueError):
        BiVAECF(likelihood="mult")
