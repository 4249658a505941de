"""The port's review models (``review_utils``, NARRE, HRDR) against the JAX
package's, on the CPU, on ``tests/data/rating.txt`` with a seeded review a
rating.

- ``build_review_tensors`` byte for byte; the initial parameters bit for
  bit (the same numpy draws in the same order), NARRE's with a seeded
  ``pretrained_word_embeddings`` dict too.
- ``text_cnn`` and ``masked_attention`` on seeded inputs, the towers and
  ``_predict`` on the same parameters (rtol 1e-5 / atol 1e-6), HRDR's
  batch normalisation in both modes (the batch's statistics, the
  population's).
- One loss, its gradients and one Adam or RMSProp step on the JAX key's
  own dropout masks (rtol 1e-5 / atol 1e-6), and one epoch on the JAX key's
  order and masks against the JAX package's one-epoch fit (rtol 1e-4 /
  atol 1e-6: float32 rounding that Adam carries through the epoch's steps);
  but for the units of the attention layers' biases whose gradient in
  float64 is 0 to rounding at every step (the softmax removes them), which
  are held to the bound of Adam's steps, as their float32 rounding walks
  them in either package (``rounding_units``).
- The empty review slots' gradients sent outside the tables
  (``review_utils.empty_slot_ids``): a step's gradients and parameters are
  the same bits as with them summed into the rows their ids name.
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
import jax.numpy as jnp
import optax

import cornac_tpu_torch
import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
from cornac_tpu.data import Reader
from cornac_tpu.models import review_utils as jru
from cornac_tpu.utils import get_rng as j_get_rng
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models import narre as narre_mod, review_utils as pru
from cornac_tpu_torch.ops.optim import adam, rmsprop, step

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
CLOSE = dict(rtol=1e-5, atol=1e-6)
EPOCH = dict(rtol=1e-4, atol=1e-6)
WORDS = ("great terrible fine awesome boring classic fresh stale loud quiet sharp dull warm "
         "cold fast slow deep shallow rich plain").split()
_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")
# small widths; R = 4 slots and L = 8 tokens, so most entities fill their
# slots, some leave them empty, and most reviews end in padding
SHARED = dict(embedding_size=8, id_embedding_size=4, n_factors=4, attention_size=4, n_filters=4,
              max_text_length=8, max_num_review=4, batch_size=16, verbose=False)
CONFIGS = {
    "NARRE": dict(SHARED),
    "NARRE-k23": dict(SHARED, kernel_sizes=[2, 3]),
    "HRDR": dict(SHARED, n_user_mlp_factors=8, n_item_mlp_factors=8),
}


def _cls(name):
    return name.split("-")[0]


@pytest.fixture(scope="module")
def splits():
    data = Reader().read(DATA, fmt="UIR")
    rng = np.random.RandomState(42)
    reviews = [(u, i, " ".join(rng.choice(WORDS, size=rng.randint(3, 12)))) for u, i, _ in data]

    def split(d, e):
        return e.RatioSplit(data=data, test_size=0.2, seed=123, exclude_unknowns=True,
                            verbose=False, review_text=d.ReviewModality(data=reviews,
                                                                        max_vocab=100))

    return split(jdata, jeval), split(pdata, peval)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _unfitted(name, js, ps, seed=3, **extra):
    """The JAX and the port model of ``name``, past ``Recommender.fit``
    (the train statistics) but not trained, and ``rng``s at the seed."""
    kw = {**CONFIGS[name], **extra}
    jm = getattr(J, _cls(name))(seed=seed, trainable=False, **kw).fit(js.train_set)
    pm = getattr(P, _cls(name))(seed=seed, trainable=False, **kw).fit(ps.train_set)
    jm._vocab = js.train_set.review_text.vocab
    pm._vocab = ps.train_set.review_text.vocab
    return jm, pm


def _jax_tensors(jm, train):
    R, L = jm.max_num_review, jm.max_text_length
    u_rev, u_ids, u_cnt = jru.build_review_tensors(train, R, L, by="user")
    i_rev, i_ids, i_cnt = jru.build_review_tensors(train, R, L, by="item")
    t = {"u_rev": u_rev, "u_ids": u_ids, "u_cnt": u_cnt, "i_rev": i_rev, "i_ids": i_ids,
         "i_cnt": i_cnt}
    if isinstance(jm, J.HRDR):
        t["u_rows"] = train.matrix.toarray().astype(np.float32)
        t["i_rows"] = train.matrix.T.toarray().astype(np.float32)
    return {k: jnp.asarray(v) for k, v in t.items()}


def _initial(name, js, ps, seed=3, **extra):
    """(JAX model, port model, the JAX initial pytree, the port's flat
    tensors of the same values, the JAX tensors, the port tensors)."""
    jm, pm = _unfitted(name, js, ps, seed, **extra)
    jp = jm._init_all(j_get_rng(seed), jm._vocab.size)
    flat = pm._init_all(j_get_rng(seed), pm._vocab.size)
    want = pru.flatten(jax.tree_util.tree_map(np.asarray, jp))
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    params = {k: torch.tensor(np.asarray(v, np.float32), requires_grad=True)
              for k, v in flat.items()}
    return jm, pm, jp, params, _jax_tensors(jm, js.train_set), pm._tensors(ps.train_set, "cpu")


# --------------------------------------------------------- review_utils --


@pytest.mark.parametrize("by", ["user", "item"])
def test_review_tensors_are_the_jax_packages_bytes(splits, by):
    js, ps = splits
    for R, L in ((4, 8), (32, 50)):
        want = jru.build_review_tensors(js.train_set, R, L, by=by)
        got = pru.build_review_tensors(ps.train_set, R, L, by=by)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_text_cnn_and_masked_attention_match():
    rng = np.random.RandomState(0)
    emb = rng.randn(3, 5, 9, 6).astype(np.float32)
    ks = [2, 3]
    convs = jru.init_text_cnn(np.random.RandomState(1), 6, ks, 4)
    flat = pru.flatten({"cnn": pru.init_text_cnn(np.random.RandomState(1), 6, ks, 4)})
    for j, conv in enumerate(convs):
        np.testing.assert_array_equal(flat[f"cnn.{j}.w"], np.asarray(conv["w"]))
    flat = {k: _t(v) for k, v in flat.items()}
    want = jru.text_cnn(convs, jnp.asarray(emb), ks)
    np.testing.assert_allclose(pru.text_cnn(flat, "cnn", _t(emb), ks).numpy(), np.asarray(want),
                               **CLOSE)
    scores = rng.randn(4, 5, 1).astype(np.float32)
    counts = np.array([0, 2, 5, 3], np.int32)
    want = jru.masked_attention(jnp.asarray(scores), jnp.asarray(counts), 5)
    got = pru.masked_attention(_t(scores), _t(counts, torch.int64), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    assert float(got[0].abs().sum()) == 0.0  # no review, no weight


def test_max_pool_gradient_splits_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 2.0]], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.max(v, axis=-1) * 2.0))(jnp.asarray(x))
    v = _t(x).requires_grad_(True)
    (torch.amax(v, dim=-1) * 2.0).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(want))


# ------------------------------------------------------- initial values --


@pytest.mark.parametrize("name", list(CONFIGS))
def test_initial_parameters_are_the_jax_packages(splits, name):
    _initial(name, *splits)  # asserts bit for bit


def test_narre_pretrained_word_embeddings(splits):
    js, ps = splits
    vocab = js.train_set.review_text.vocab
    rng = np.random.RandomState(5)
    pre = {tok: rng.randn(SHARED["embedding_size"]).astype(np.float32)
           for tok in list(vocab.tok2idx)[4::2]}
    jm, pm, jp, params, _, _ = _initial("NARRE", js, ps, init_params={
        "pretrained_word_embeddings": pre})
    tok = list(vocab.tok2idx)[4]
    np.testing.assert_array_equal(params["word_u"][vocab.tok2idx[tok]].detach().numpy(), pre[tok])


# --------------------------------------------------- forward, gradients --


def _jax_masks(key, B, FK, keep):
    ku, ki = jax.random.split(key)
    return tuple(_t(jax.random.bernoulli(k, keep, (B, FK))).to(torch.float32) for k in (ku, ki))


def _batch(train, B=12, seed=0):
    rng = np.random.RandomState(seed)
    uid, iid, rat = train.uir_tuple
    idx = rng.randint(len(uid), size=B)
    return uid[idx], iid[idx], rat[idx].astype(np.float32)


def _jax_predict(jm, jp, u, i, jt, key, stats=None):
    if isinstance(jm, J.HRDR):
        su, si = (None, None) if stats is None else stats
        return jm._predict(jp, jnp.asarray(u), jnp.asarray(i), jt, key, su, si)[0]
    return jm._predict(jp, jnp.asarray(u), jnp.asarray(i), jt, key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_towers_and_predictions_match(splits, name):
    js, ps = splits
    jm, pm, jp, params, jt, pt = _initial(name, js, ps)
    u, i, _ = _batch(js.train_set)
    key = jax.random.PRNGKey(7)
    masks = _jax_masks(key, len(u), pm._filters, 1.0 - pm.dropout_rate)
    with torch.no_grad():
        got = pm._predict(params, pt, _t(u, torch.int64), _t(i, torch.int64), masks)[0]
        plain = pm._predict(params, pt, _t(u, torch.int64), _t(i, torch.int64), None)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_predict(jm, jp, u, i, jt, key)),
                               **CLOSE)
    np.testing.assert_allclose(plain.numpy(), np.asarray(_jax_predict(jm, jp, u, i, jt, None)),
                               **CLOSE)
    if isinstance(jm, J.HRDR):  # the population statistics
        stats = tuple(jm._population_bn_stats(jp, jt, s) for s in ("u", "i"))
        mine = pm._eval_stats(params, pt)
        for a, b in zip(mine, stats):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), **CLOSE)
        with torch.no_grad():
            got = pm._predict(params, pt, _t(u, torch.int64), _t(i, torch.int64), None, mine)[0]
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(_jax_predict(jm, jp, u, i, jt, None, stats)),
                                   **CLOSE)


@pytest.mark.parametrize("name,optimizer", [("NARRE", "adam"), ("NARRE-k23", "rmsprop"),
                                            ("HRDR", "adam")])
def test_loss_gradients_and_one_step_match(splits, name, optimizer):
    js, ps = splits
    jm, pm, jp, params, jt, pt = _initial(name, js, ps)
    u, i, r = _batch(js.train_set)
    key = jax.random.PRNGKey(11)
    masks = _jax_masks(key, len(u), pm._filters, 1.0 - pm.dropout_rate)

    def jloss(p):
        return jnp.mean((_jax_predict(jm, p, u, i, jt, key) - jnp.asarray(r)) ** 2)

    j_val, j_grads = jax.jit(jax.value_and_grad(jloss))(jp)  # as the JAX fit runs it
    loss = pm.loss_on(params, pt, _t(u, torch.int64), _t(i, torch.int64), _t(r), masks)
    np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-6)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = pru.flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], **CLOSE, err_msg=k)
    make_j, make_p = (optax.adam, adam) if optimizer == "adam" else (optax.rmsprop, rmsprop)
    jopt = make_j(0.01)
    updates, _ = jopt.update(j_grads, jopt.init(jp), jp)
    jnew = pru.flatten(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, updates)))
    popt = make_p(0.01)
    batch = (_t(u, torch.int64), _t(i, torch.int64), _t(r), masks)
    exempt = rounding_units([_float64_bias_grads(pm.loss_on, params, pt, *batch)])
    loss = pm.loss_on(params, pt, *batch)
    step(params, popt, popt.init(params), loss)
    for k, p in params.items():
        _held(p.detach().numpy(), jnew[k], k, 0.01, 1, CLOSE, exempt)


# The attention layers' biases: the second layer's is added to every
# slot's score and the softmax removes it, and so it removes the first
# layer's bias of a unit active in every slot of every row. Such gradients
# are exactly 0; in float64 they come out under 1e-18 on these data, in
# float32 as rounding, which Adam and RMSProp turn into steps of up to
# about 3.16 lr in either package, differently. The real gradients of these
# biases on these data are above 3e-7.
ROUNDING = 1e-15


def _float64_bias_grads(loss_on, params, t, u, i, r, masks):
    """The attention biases' gradients of ``loss_on`` in float64 at
    ``params``, on ``t``'s tensors and the keep ``masks`` made float64."""
    p = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    t = {k: v.double() if v.is_floating_point() else v for k, v in t.items()}
    masks = None if masks is None else tuple(m.double() for m in masks)
    names = [k for k in p if k.startswith("att_") and k.endswith(".b")]
    loss = loss_on(p, t, u, i, r.double(), masks)
    return dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))


def rounding_units(step_grads):
    """{name: boolean mask} of the attention bias units whose float64
    gradient is 0 to rounding in every step of ``step_grads`` (a list of
    ``_float64_bias_grads``)."""
    return {k: np.logical_and.reduce([g[k].abs().numpy() <= ROUNDING for g in step_grads])
            for k in step_grads[0]}


def _held(got, want, name, lr, steps, tol, exempt):
    """A parameter after ``steps`` Adam or RMSProp steps at ``lr`` against
    the JAX package's: within ``tol``, but for its units in ``exempt``
    (``rounding_units``), held to the steps' bound."""
    units = exempt.get(name, np.zeros(got.shape, bool))
    assert np.abs(got - want)[units].max(initial=0.0) <= 2 * 3.17 * lr * steps, name
    np.testing.assert_allclose(got[~units], want[~units], **tol, err_msg=name)


@pytest.mark.parametrize("name", ["NARRE", "HRDR"])
def test_skipping_empty_slots_keeps_the_bits(splits, monkeypatch, name):
    js, ps = splits
    _, pm, _, params, _, pt = _initial(name, js, ps, max_num_review=16)
    for side in ("u", "i"):  # some slots are empty on either side
        assert bool((pt[side + "_cnt"] < pm.max_num_review).any())
    u, i, r = _batch(ps.train_set, B=40, seed=4)
    masks = pm.draws(torch.Generator().manual_seed(0), len(u))
    out = {}
    for skip in (False, True):
        if not skip:  # every slot's gradient summed into the rows its ids name
            monkeypatch.setattr(narre_mod, "empty_slot_ids", lambda ids, cnt, past: ids)
        else:
            monkeypatch.undo()
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss = pm.loss_on(p, pt, _t(u, torch.int64), _t(i, torch.int64), _t(r), masks)
        grads = torch.autograd.grad(loss, list(p.values()))
        opt = adam(0.01)
        loss = pm.loss_on(p, pt, _t(u, torch.int64), _t(i, torch.int64), _t(r), masks)
        step(p, opt, opt.init(p), loss)
        out[skip] = (grads, p)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for k in params:
        assert torch.equal(out[False][1][k], out[True][1][k]), k


# ---------------------------------------------------------- whole epoch --


@pytest.fixture(scope="module")
def jax_fits(splits):
    """One-epoch JAX fits (not verbose: the epoch key is fold_in(key, 0))."""
    js, _ = splits
    return {name: getattr(J, _cls(name))(seed=3, max_iter=1, **CONFIGS[name]).fit(js.train_set)
            for name in ("NARRE", "HRDR")}


@pytest.mark.parametrize("name", ["NARRE", "HRDR"])
def test_one_epoch_on_the_jax_draws_matches_the_jax_fit(splits, jax_fits, name):
    js, ps = splits
    jm = jax_fits[name]
    _, pm, _, params, _, pt = _initial(name, js, ps)
    rng = j_get_rng(3)
    pm._init_all(rng, pm._vocab.size)  # the initial draws
    ekey = jax.random.fold_in(jax.random.PRNGKey(rng.randint(2**31)), 0)
    train = ps.train_set
    uid, iid, rat = train.uir_tuple
    n, bsz = len(uid), CONFIGS[name]["batch_size"]
    n_total = n + (-n) % bsz
    order = _t(jax.random.permutation(ekey, n_total) % n, torch.int64)
    steps = iter(range(n_total // bsz))
    data = (_t(uid, torch.int64), _t(iid, torch.int64), _t(rat, torch.float32))
    opt = adam(pm.learning_rate)
    loss_on, step_grads = pm.loss_on, []

    def recording(*args):  # each step's attention-bias gradients in float64
        step_grads.append(_float64_bias_grads(loss_on, *args))
        return loss_on(*args)

    pm.loss_on = recording
    pm.epoch(params, opt, opt.init(params), pt, order, data,
             lambda B: _jax_masks(jax.random.fold_in(ekey, next(steps)), B, pm._filters,
                                  1.0 - pm.dropout_rate), bsz)
    assert len(step_grads) == n_total // bsz
    exempt = rounding_units(step_grads)
    # the second layer's biases only, and in the first layer only some units
    assert all(exempt[f"att_{s}2.b"].all() for s in "ui")
    assert not all(exempt[f"att_{s}1.b"].all() for s in "ui")
    want = pru.flatten(jax.tree_util.tree_map(np.asarray, jm.params))
    for k, p in params.items():
        _held(p.detach().numpy(), want[k], k, pm.learning_rate, n_total // bsz, EPOCH, exempt)


# -------------------------------------------------------------- scoring --


@pytest.mark.parametrize("name", ["NARRE", "HRDR"])
def test_scores_through_convert_match_jax(splits, jax_fits, name):
    js, ps = splits
    jm = jax_fits[name]
    options = ["embedding_size", "id_embedding_size", "n_factors", "attention_size",
               "kernel_sizes", "n_filters", "max_text_length", "max_num_review"]
    if name == "HRDR":
        options += ["n_user_mlp_factors", "n_item_mlp_factors"]
    meta = {n: getattr(jm, n) for n in _SNAPSHOT + tuple(options)}
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    pm = model_from_params(name, params, meta, device="cpu", train_set=ps.train_set)
    np.testing.assert_allclose(pm.P, jm.P, **CLOSE)
    np.testing.assert_allclose(pm.Q, jm.Q, **CLOSE)
    if name == "HRDR":
        assert len(pm.bn_stats) == 2
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **CLOSE)
    for u in (0, jm.num_users - 1):
        np.testing.assert_allclose(pm.score(u), jm.score(u), **CLOSE)
        np.testing.assert_allclose(pm.score(u, 2), jm.score(u, 2), **CLOSE)
    items = np.arange(jm.num_users) % jm.num_items
    want = np.array([jm.score(u, i) for u, i in zip(users, items)])
    np.testing.assert_allclose(pm.score_pairs(users, items), want, **CLOSE)
    np.testing.assert_allclose(pm.get_item_vectors(), jm.get_item_vectors(), **CLOSE)
    raw = list(jm.uid_map)[:6]
    for k in (5, -1):
        assert pm.recommend_batch(raw, k=k) == jm.recommend_batch(raw, k=k)
    assert pm.recommend(raw[0], k=4) == jm.recommend(raw[0], k=4)


@pytest.mark.parametrize("name", ["NARRE", "HRDR"])
def test_fit_best_model_selection_and_refit_bits(splits, name):
    js, ps = splits
    kw = dict(CONFIGS[name], max_iter=2, model_selection="best")
    with one_thread():  # a CPU product's sums follow the threads it gets
        a = getattr(P, name)(seed=5, **kw).fit(ps.train_set, ps.val_set or ps.test_set)
        b = getattr(P, name)(seed=5, **kw).fit(ps.train_set, ps.val_set or ps.test_set)
    assert len(a.losses["val_losses"]) == 2 and a.best_epoch in (1, 2)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    np.testing.assert_array_equal(a.P, b.P)


@pytest.mark.parametrize("cls", [P.NARRE, P.HRDR])
def test_mesh_is_refused(cls):
    # mesh= is ported (tests/test_torch_parallel_text.py): anything but a
    # parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        cls(mesh=object())


@pytest.mark.parametrize("cls", [P.NARRE, P.HRDR])
def test_review_modality_is_required(cls):
    data = Reader().read(DATA, fmt="UIR")
    split = peval.RatioSplit(data=data, test_size=0.2, seed=1, verbose=False)
    with pytest.raises(ValueError, match="review_text"):
        cls(max_iter=1, verbose=False).fit(split.train_set)
