"""The port's item-text models (CDL, CDR, CVAE, ConvMF, CTR, HFT) against
the JAX package's, on the CPU, on ``tests/data/rating.txt`` with a seeded
document an item.

- Initial parameters bit for bit (the same numpy draws in the same order).
- One epoch of CDL, CDR and CVAE on the JAX key's own corruption masks,
  negatives and noise (and the JAX package's numpy order for CVAE) against
  the JAX package's one-epoch fit: every parameter within rtol 1e-4 /
  atol 1e-6, float32 rounding that Adam carries through the epoch's steps.
- ConvMF's and CTR's whole fits (their orders and draws are the fit's numpy
  generator's, as in the JAX package) against the JAX fits: U and V within
  rtol 1e-4 / atol 1e-5 (ALS and the CNN's Adam steps in float32); HFT's
  fit (host float64 in both packages) bit for bit.
- ``score``, ``score_batch``, ``score_pairs`` and ``recommend`` on
  parameters carried across by ``convert.model_from_params`` (rtol 1e-5);
  ``mesh=`` refused.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax

import cornac_tpu_torch
import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
from cornac_tpu.data import Reader
from cornac_tpu.utils import get_rng as j_get_rng
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.engine.nn import ACTIVATIONS
from cornac_tpu_torch.models import cdl as cdl_mod, cvae as cvae_mod
from cornac_tpu_torch.models.review_utils import flatten
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.ops.optim import adam

cornac_tpu_torch.set_default_device("cpu")


@contextlib.contextmanager
def one_thread():
    """One CPU thread while open: the sums of a product on the CPU follow
    the number of threads its library gives it, which a loaded machine can
    change between two fits; on one thread they are fixed."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rating.txt")
EPOCH = dict(rtol=1e-4, atol=1e-6)
FIT = dict(rtol=1e-4, atol=1e-5)
SCORES = dict(rtol=1e-5, atol=1e-6)
WORDS = [f"w{chr(97 + k % 26)}{chr(97 + k // 26)}" for k in range(60)]
_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")

CDL_KW = dict(k=4, autoencoder_structure=[6], batch_size=8, learning_rate=0.01, verbose=False)
CDR_KW = dict(k=4, autoencoder_structure=[6], batch_size=16, learning_rate=0.01, verbose=False)
CVAE_KW = dict(z_dim=4, vae_layers=(8, 6), batch_size=8, lr=0.01, verbose=False)
CONVMF_KW = dict(k=4, cnn_epochs=1, cnn_bs=8, emb_dim=6, max_len=12, filter_sizes=(2, 3),
                 num_filters=3, hidden_dim=5, verbose=False)
CTR_KW = dict(k=4, lambda_v=1, verbose=False)
HFT_KW = dict(k=3, max_iter=3, grad_iter=4, verbose=False)


@pytest.fixture(scope="module")
def splits():
    data = Reader().read(DATA, fmt="UIR")
    items = sorted({i for _, i, _ in data})
    rng = np.random.RandomState(0)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    docs = [" ".join(rng.choice(WORDS, size=rng.randint(4, 20), p=p / p.sum())) for _ in items]

    def split(d, e):
        return e.RatioSplit(data=data, test_size=0.2, rating_threshold=3.0, seed=123,
                            exclude_unknowns=True, verbose=False,
                            item_text=d.TextModality(corpus=docs, ids=items, max_vocab=50))

    return split(jdata, jeval), split(pdata, peval)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _flat_jax(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


def _key(rng):
    """The JAX fit's key: ``PRNGKey`` of its generator's next draw."""
    return jax.random.PRNGKey(rng.randint(2**31))


def _mask(key, shape, keep):
    return _t(jax.random.bernoulli(key, keep, shape)).to(torch.float32)


# ----------------------------------------------------------------- CDL --


def test_cdl_initial_values_and_one_epoch_on_the_jax_masks(splits):
    js, ps = splits
    jm = J.CDL(seed=3, max_iter=1, **CDL_KW).fit(js.train_set)
    j0 = J.CDL(seed=3, trainable=False, **CDL_KW).fit(js.train_set)
    pm = P.CDL(seed=3, trainable=False, **CDL_KW).fit(ps.train_set)
    np.testing.assert_array_equal(pm.U, j0.U)
    np.testing.assert_array_equal(pm.V, j0.V)
    train = ps.train_set
    text = cdl_mod.minmax_text(train, pm.num_items)
    rng = j_get_rng(3)
    rng.uniform(size=pm.U.size), rng.uniform(size=pm.V.size)  # the initial draws
    sdae = {n: torch.tensor(a, requires_grad=True) for n, a in pm._initial(rng, text.shape[1])
            .items()}
    params = {"U": torch.tensor(pm.U, requires_grad=True),
              "V": torch.tensor(pm.V, requires_grad=True)}
    ekey = jax.random.fold_in(_key(rng), 0)
    n, bsz = pm.num_items, CDL_KW["batch_size"]
    n_total = n + (-n) % bsz
    order = _t(jax.random.permutation(ekey, n_total) % n, torch.int64)
    R_t = np.asarray(train.csc_matrix.T.todense(), np.float32)
    data = (_t(text), _t(R_t), _t(np.where(R_t != 0, pm.a, pm.b).astype(np.float32)))
    steps = iter(range(n_total // bsz))
    opts = (adam(pm.learning_rate), adam(pm.learning_rate))
    cdl_mod.cdl_epoch(params, sdae, opts, (opts[0].init(params), opts[1].init(sdae)), order,
                      data, lambda shape: _mask(jax.random.fold_in(ekey, next(steps)), shape,
                                                1.0 - pm.corruption_rate),
                      bsz, ACTIVATIONS[pm.act_fn],
                      (pm.lambda_u, pm.lambda_v, pm.lambda_w, pm.lambda_n))
    np.testing.assert_allclose(params["U"].detach().numpy(), jm.U, **EPOCH)
    np.testing.assert_allclose(params["V"].detach().numpy(), jm.V, **EPOCH)


# ----------------------------------------------------------------- CDR --


def test_cdr_initial_values_and_one_epoch_on_the_jax_draws(splits):
    js, ps = splits
    jm = J.CDR(seed=4, max_iter=1, **CDR_KW).fit(js.train_set)
    pm = P.CDR(seed=4, trainable=False, **CDR_KW).fit(ps.train_set)
    j0 = J.CDR(seed=4, trainable=False, **CDR_KW).fit(js.train_set)
    np.testing.assert_array_equal(pm.U, j0.U)
    train = ps.train_set
    text = cdl_mod.minmax_text(train, pm.num_items)
    rng = j_get_rng(4)
    rng.uniform(size=pm.U.size), rng.uniform(size=pm.V.size)
    params = {"U": pm.U, "V": pm.V, **pm._initial(rng, text.shape[1])}
    params = {n: torch.tensor(np.asarray(a, np.float32), requires_grad=True)
              for n, a in params.items()}
    ekey = jax.random.fold_in(_key(rng), 0)
    rid, cid, _ = train.uir_tuple
    n, bsz = len(rid), CDR_KW["batch_size"]
    n_total = -(-n // bsz) * bsz
    k_pos, k_neg = jax.random.split(ekey)
    draws = (_t(jax.random.randint(k_pos, (n_total,), 0, n), torch.int64),
             _t(jax.random.randint(k_neg, (n_total,), 0, train.num_items), torch.int64))
    data = (_t(text), _t(np.stack([rid, cid], 1).astype(np.int64)),
            build_membership(train.csr_matrix, device="cpu"))
    steps = iter(range(n_total // bsz))
    opt = adam(pm.learning_rate)
    cvae_mod.cdr_epoch(params, opt, opt.init(params), draws, data,
                       lambda shape: _mask(jax.random.fold_in(ekey, next(steps)), shape,
                                           1.0 - pm.corruption_rate),
                       bsz, ACTIVATIONS[pm.act_fn],
                       (pm.lambda_u, pm.lambda_v, pm.lambda_w, pm.lambda_n))
    np.testing.assert_allclose(params["U"].detach().numpy(), jm.U, **EPOCH)
    np.testing.assert_allclose(params["V"].detach().numpy(), jm.V, **EPOCH)


# ---------------------------------------------------------------- CVAE --


@pytest.mark.parametrize("loss_type", ["cross-entropy", "rmse"])
def test_cvae_initial_values_and_one_epoch_on_the_jax_noise(splits, loss_type):
    js, ps = splits
    kw = dict(CVAE_KW, loss_type=loss_type)
    jm = J.CVAE(seed=5, n_epochs=1, **kw).fit(js.train_set)
    j0 = J.CVAE(seed=5, trainable=False, **kw).fit(js.train_set)
    pm = P.CVAE(seed=5, trainable=False, **kw).fit(ps.train_set)
    np.testing.assert_array_equal(pm.U, j0.U)
    np.testing.assert_array_equal(pm.V, j0.V)
    train = ps.train_set
    text = train.item_text.batch_bow(np.arange(pm.num_items)).astype(np.float32)
    text = text / np.maximum(text.max(), 1e-12)
    rng = j_get_rng(5)
    rng.uniform(size=pm.U.size), rng.uniform(size=pm.V.size)
    vae = {n: torch.tensor(a, requires_grad=True) for n, a in pm._initial(rng, text.shape[1])
           .items()}
    key = _key(rng)
    opt = adam(pm.lr)
    U, V, _ = pm.epoch(vae, opt, opt.init(vae), _t(pm.V), _t(text),
                       cvae_mod.padded_layouts(train.matrix, "cpu"),
                       rng.permutation(pm.num_items),
                       lambda s, shape: _t(jax.random.normal(jax.random.fold_in(key, s), shape)))
    np.testing.assert_allclose(U.numpy(), jm.U, **EPOCH)
    np.testing.assert_allclose(V.numpy(), jm.V, **EPOCH)
    want = _flat_jax(jm.vae)
    for n, p in vae.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], **EPOCH, err_msg=n)


# ------------------------------------------------- ConvMF, CTR and HFT --


def test_convmf_whole_fit_matches_the_jax_fit(splits):
    js, ps = splits
    jm = J.ConvMF(seed=6, n_epochs=2, **CONVMF_KW).fit(js.train_set)
    pm = P.ConvMF(seed=6, n_epochs=2, **CONVMF_KW).fit(ps.train_set)
    j0 = J.ConvMF(seed=6, trainable=False, **CONVMF_KW).fit(js.train_set)
    p0 = P.ConvMF(seed=6, trainable=False, **CONVMF_KW).fit(ps.train_set)
    np.testing.assert_array_equal(p0.U, j0.U)
    for name in ("U", "V", "theta"):
        np.testing.assert_allclose(getattr(pm, name), np.asarray(getattr(jm, name)), **FIT,
                                   err_msg=name)
    want = _flat_jax(jm.cnn)
    for n, p in pm.cnn.items():
        np.testing.assert_allclose(p.numpy(), want[n], **FIT, err_msg=n)


def test_ctr_whole_fit_matches_the_jax_fit(splits):
    js, ps = splits
    jm = J.CTR(seed=7, max_iter=3, **CTR_KW).fit(js.train_set)
    pm = P.CTR(seed=7, max_iter=3, **CTR_KW).fit(ps.train_set)
    for name in ("U", "V", "theta", "beta"):
        np.testing.assert_allclose(getattr(pm, name), getattr(jm, name), **FIT, err_msg=name)


def test_hft_fit_is_the_jax_fit_bit_for_bit(splits):
    js, ps = splits
    jm = J.HFT(seed=8, **HFT_KW).fit(js.train_set)
    pm = P.HFT(seed=8, **HFT_KW).fit(ps.train_set)
    assert pm.alpha == jm.alpha
    for name in ("beta_u", "beta_i", "gamma_u", "gamma_i"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name), err_msg=name)


# -------------------------------------------------------------- scores --


def _fitted(name, js):
    if name == "CDL":
        return J.CDL(seed=2, max_iter=2, **CDL_KW).fit(js.train_set), {"k": 4}
    if name == "CDR":
        return J.CDR(seed=2, max_iter=2, **CDR_KW).fit(js.train_set), {"k": 4}
    if name == "CVAE":
        return J.CVAE(seed=2, n_epochs=2, **CVAE_KW).fit(js.train_set), {"z_dim": 4}
    if name == "CTR":
        return J.CTR(seed=2, max_iter=2, **CTR_KW).fit(js.train_set), {"k": 4}
    if name == "ConvMF":
        return (J.ConvMF(seed=2, n_epochs=2, **CONVMF_KW).fit(js.train_set),
                {"k": 4, "filter_sizes": CONVMF_KW["filter_sizes"]})
    return J.HFT(seed=2, **HFT_KW).fit(js.train_set), {"k": 3}


@pytest.mark.parametrize("name", ["CDL", "CDR", "CVAE", "CTR", "ConvMF", "HFT"])
def test_scores_through_convert_match_jax(splits, name):
    js, ps = splits
    jm, options = _fitted(name, js)
    if name == "HFT":
        params = {n: getattr(jm, n) for n in ("alpha", "beta_u", "beta_i", "gamma_u", "gamma_i")}
    elif name == "ConvMF":
        params = {"U": jm.U, "V": jm.V, "theta": jm.theta,
                  "cnn": jax.tree_util.tree_map(np.asarray, jm.cnn)}
    else:
        params = {"U": jm.U, "V": jm.V}
    pm = model_from_params(name, params, {**{n: getattr(jm, n) for n in _SNAPSHOT}, **options},
                           device="cpu", train_set=ps.train_set)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **SCORES)
    for u in (0, jm.num_users - 1):
        np.testing.assert_allclose(pm.score(u), jm.score(u), **SCORES)
        np.testing.assert_allclose(pm.score(u, 3), jm.score(u, 3), **SCORES)
    items = users % jm.num_items
    np.testing.assert_allclose(pm.score_pairs(users, items), jm.score_pairs(users, items),
                               **SCORES)
    raw = list(jm.uid_map)[:6]
    for k in (5, -1):
        assert pm.recommend_batch(raw, k=k) == jm.recommend_batch(raw, k=k)
    if name == "ConvMF":  # the CNN carried across encodes the documents as the JAX one
        docs = ps.train_set.item_text.batch_seq(np.arange(jm.num_items),
                                                max_length=CONVMF_KW["max_len"])
        np.testing.assert_allclose(pm.encode(pm.cnn, _t(docs, torch.int64)).numpy(), jm.theta,
                                   **SCORES)


@pytest.mark.parametrize("name", ["CDL", "CDR", "CVAE"])
def test_seeded_refits_are_bit_for_bit(splits, name):
    _, ps = splits
    kw = {"CDL": CDL_KW, "CDR": CDR_KW, "CVAE": CVAE_KW}[name]
    depth = {"CVAE": {"n_epochs": 2}}.get(name, {"max_iter": 2})
    with one_thread():  # a CPU product's sums follow the threads it gets
        a = getattr(P, name)(seed=9, **kw, **depth).fit(ps.train_set)
        b = getattr(P, name)(seed=9, **kw, **depth).fit(ps.train_set)
    np.testing.assert_array_equal(a.U, b.U)
    np.testing.assert_array_equal(a.V, b.V)


@pytest.mark.parametrize("cls", [P.CDL, P.CDR, P.CVAE, P.ConvMF, P.CTR, P.HFT])
def test_mesh_is_refused(cls):
    # mesh= is ported for all but HFT (tests/test_torch_parallel_text.py):
    # anything but a parallel.make_mesh mesh is refused; HFT refuses any
    # mesh, as the JAX package's HFT takes none
    if cls is P.HFT:
        with pytest.raises(NotImplementedError, match="cornac_tpu.models.HFT"):
            cls(mesh=object())
    else:
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(mesh=object())


@pytest.mark.parametrize("cls", [P.CDL, P.CDR, P.CVAE, P.ConvMF, P.CTR, P.HFT])
def test_item_text_is_required(cls):
    data = Reader().read(DATA, fmt="UIR")
    split = peval.RatioSplit(data=data, test_size=0.2, seed=1, verbose=False)
    with pytest.raises(ValueError, match="item_text"):
        cls(verbose=False).fit(split.train_set)
