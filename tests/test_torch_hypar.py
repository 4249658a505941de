"""The port's HypAR against the JAX package's, on the CPU, on
``tests/data/rating.txt`` with seeded (aspect, opinion, polarity) tuples.

- The stem maps with NLTK and with NLTK blocked (its import fails, and both
  packages lower-case), the graphs and the aspect / opinion content
  vectors (``svds`` from one fixed start, ``fixed_svds_start``: scipy 1.17
  draws its start from fresh entropy, which ``np.random.seed`` does not
  fix), byte for byte; the initial parameters bit for bit.
- The forward pass (node and prediction embeddings) within rtol 1e-5 on
  the same parameters, for the default configuration and six others that
  cover every combiner, aggregator, predictor, preference module,
  objective, explainability loss and dropout.
- One loss on the JAX key's own draws (the loss captured from the JAX
  fit's ``jax.value_and_grad``, nothing compiled), its gradients and one
  AdamW step, and one short epoch against the JAX fit's: within 1e-5 (the
  loss) and 1e-4 (gradients, parameters). The attention's segment max
  leaves units whose gradient is exactly 0 in exact arithmetic (a node
  with one review: its softmax is 1 whatever its score); their float32
  gradients are rounding in either package, which Adam turns into steps of
  up to about lr, so they alone are held to that bound.
- Scoring through ``convert.model_from_params``; a seeded refit bit for bit.
"""

import copy
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
import cornac_tpu_torch
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu.data import Reader
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models.hypar import HypARNet, fixed_svds_start
from cornac_tpu_torch.models.review_utils import flatten
from cornac_tpu_torch.ops.optim import adamw, step

cornac_tpu_torch.set_default_device("cpu")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rating.txt")
ASPECTS = ["Battery-life", "batteries", "Screen", "screens", "price", "pricing", "camera"]
OPINIONS = ["good", "Goodness", "bad", "great", "greatly", "poor"]
SEED = 123
FORWARD = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
ROUNDING = 1e-12  # |float64 gradient| of a unit that is 0 in exact arithmetic
BASE = dict(node_dim=8, num_heads=2, num_epochs=1, batch_size=16, num_neg_samples=4,
            learning_rate=0.01, model_selection="last", seed=SEED, verbose=False)
CONFIGS = {
    "default": dict(),
    "rating-dot-concat-mf": dict(objective="rating", predictor="dot", combiner="concat",
                                 preference_module="mf", embedding_type="learned",
                                 weight_decay=0.01),
    "explain-transr-dropout": dict(learn_explainability=True, learn_method="transr",
                                   layer_dropout=0.1, combiner="self"),
    "explain-nl-gatv2": dict(learn_explainability=True, learn_method="non-linear",
                             combiner="bi-interaction", review_aggregator="gatv2",
                             graph_type="as", layer_dropout=(0.2, 0.1)),
}


@pytest.fixture(autouse=True)
def pinned_svds():
    with fixed_svds_start(0):
        yield


@pytest.fixture(scope="module")
def splits():
    data = Reader().read(DATA, fmt="UIR")
    rng = np.random.RandomState(4)
    lexicon = [(u, i, [(ASPECTS[rng.randint(len(ASPECTS))], OPINIONS[rng.randint(len(OPINIONS))],
                        float(rng.choice([-1, 1]))) for _ in range(rng.randint(1, 4))])
               for u, i, r in data]

    def split(d, e):
        return e.RatioSplit(data=data, test_size=0.2, rating_threshold=3.0, seed=123,
                            exclude_unknowns=True, verbose=False,
                            sentiment=d.SentimentModality(data=lexicon))

    return split(jdata, jeval), split(pdata, peval)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.array(a)).to(dtype)


def _flat_jax(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


class _Captured(Exception):
    pass


def _jax_parts(js, config, monkeypatch):
    """The JAX model set up by its fit (graphs, adjacency), its loss
    function (captured), its initial parameters and its key."""
    jm = J.HypAR(**BASE, **config)
    captured = {}
    real = jax.value_and_grad

    def capture(fn, *args, **kw):
        captured["loss_fn"] = fn
        raise _Captured

    monkeypatch.setattr(jax, "value_and_grad", capture)
    with pytest.raises(_Captured):
        jm.fit(js.train_set)
    monkeypatch.setattr(jax, "value_and_grad", real)
    ao = jm._ao_content_embeddings(js.train_set) if jm.embedding_type == "ao_embeddings" else None
    rng = np.random.RandomState(SEED)
    params = jm._init_params(rng, ao)
    return jm, captured["loss_fn"], params, jax.random.PRNGKey(rng.randint(2**31))


def _port(ps, config):
    pm = P.HypAR(trainable=False, **BASE, **config).fit(ps.train_set)
    return pm


def _jax_draws(jm, key_e, b, perm, bsz):
    """Step ``b``'s draws of the JAX epoch keyed ``key_e``, as the port's
    ``loss_on`` takes them."""
    key_b = jax.random.fold_in(key_e, b)
    kn = jax.random.fold_in(key_b, 1)
    shape = (jm.n_nodes, jm.node_dim)
    draws = {"idx": _t(perm[b * bsz:(b + 1) * bsz])}
    if jm.layer_dropout[0] > 0:
        keep = 1.0 - jm.layer_dropout[0]
        draws["layer_masks"] = [_t(jax.random.bernoulli(jax.random.fold_in(kn, li * 7), keep,
                                                        shape), torch.float32)
                                for li in range(3)]
    if jm.attention_dropout > 0:
        draws["att_mask"] = _t(jax.random.bernoulli(
            jax.random.fold_in(kn, 91), 1.0 - jm.attention_dropout,
            (len(jm.rev_edges), jm.num_heads)), torch.float32)
    if jm.layer_dropout[1] > 0:
        draws["out_mask"] = _t(jax.random.bernoulli(
            jax.random.fold_in(kn, 92), 1.0 - jm.layer_dropout[1], shape), torch.float32)
    if jm.objective == "ranking":
        draws["neg"] = _t(jax.random.randint(jax.random.fold_in(key_b, 2),
                                             (bsz, jm.num_neg_samples), 0, jm.num_items))
    if jm.learn_explainability:
        draws["aos_neg"] = _t(jax.random.randint(jax.random.fold_in(key_b, 3), (bsz,), 0,
                                                 len(jm.aos_list)))
    return draws


def _epoch_plan(jm, key, e=0):
    n_edges = len(jm.edge_u)
    bsz = min(jm.batch_size, n_edges)
    n_total = n_edges + ((-n_edges) % bsz)
    key_e = jax.random.fold_in(key, e)
    perm = np.asarray(jax.random.permutation(key_e, n_total) % n_edges)
    return key_e, perm, bsz, n_total // bsz


def _float64_grads(pm, draws):
    """Every parameter's gradient of the port's loss in float64."""
    net = pm.net
    graph = copy.copy(net.graph)
    graph.adj = copy.copy(graph.adj)
    if graph.adj.dense is not None:
        graph.adj.dense = graph.adj.dense.double()
    else:
        graph.adj.edge_norm = graph.adj.edge_norm.double()
    graph.stats = {c: (dv.double(), de.double()) for c, (dv, de) in graph.stats.items()}
    feats = None if net.ao_feats is None else net.ao_feats.double()
    net64 = HypARNet(pm, {n: p.detach().double() for n, p in net.params.items()}, graph, feats)
    d64 = {k: ([m.double() for m in v] if isinstance(v, list) else
               v.double() if v.is_floating_point() else v) for k, v in draws.items()}
    loss = net64.loss_on(d64)
    params = net64.params
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                allow_unused=True, materialize_grads=True)))


def _held(got, want, name, lr, steps, exempt):
    units = exempt.get(name, np.zeros(got.shape, bool))
    assert np.abs(got - want)[units].max(initial=0.0) <= 2 * 1.01 * lr * steps, name
    np.testing.assert_allclose(got[~units], want[~units], **STEP, err_msg=name)


# ---------------------------------------------------------- host builds --


@pytest.mark.parametrize("blocked", [False, True], ids=["nltk", "nltk-blocked"])
def test_stem_maps_and_graphs_are_the_jax_bytes(splits, monkeypatch, blocked):
    js, ps = splits
    if blocked:
        monkeypatch.setitem(sys.modules, "nltk", None)
        monkeypatch.setitem(sys.modules, "nltk.stem", None)
    for graph_type in ("aos", "as"):
        jm = J.HypAR(graph_type=graph_type, **BASE)
        pm = P.HypAR(graph_type=graph_type, **BASE)
        for m, tr in ((jm, js.train_set), (pm, ps.train_set)):
            m.trainable = False
            m.num_users, m.num_items = tr.num_users, tr.num_items
            m._create_graphs(tr)
        assert (pm.a2a, pm.o2o) == (jm.a2a, jm.o2o)
        assert (pm.n_aspects, pm.n_opinions, pm.n_nodes, pm.n_sids) == (
            jm.n_aspects, jm.n_opinions, jm.n_nodes, jm.n_sids)
        assert pm.hyper_edges.keys() == jm.hyper_edges.keys()
        for c in jm.hyper_edges:
            for a, b in zip(pm.hyper_edges[c], jm.hyper_edges[c]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for n in ("rev_edges", "aos_list", "edge_u", "edge_i", "edge_r", "edge_sid"):
            a, b = getattr(pm, n), getattr(jm, n)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n
        assert pm.aos_per_sid == jm.aos_per_sid
        want = jm._ao_content_embeddings(js.train_set)
        got = pm._ao_content_embeddings(ps.train_set)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()
    # the stemmer merges these spellings; lower-casing keeps them apart
    assert (pm.n_aspects < len(ASPECTS)) != blocked


# ------------------------------------------------- forward, loss, step --


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_loss_gradients_and_one_step_match(splits, monkeypatch, config):
    js, ps = splits
    jm, loss_fn, jparams, key = _jax_parts(js, CONFIGS[config], monkeypatch)
    pm = _port(ps, CONFIGS[config])
    want0 = _flat_jax(jparams)
    params = pm.net.params
    assert params.keys() == want0.keys()
    for n, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want0[n], err_msg=n)

    j_rep, j_star = jm._node_embeddings(jparams, None)
    with torch.no_grad():
        p_rep, p_star = pm.net.node_embeddings(None)
    np.testing.assert_allclose(p_rep.numpy(), np.asarray(j_rep), **FORWARD)
    np.testing.assert_allclose(p_star.numpy(), np.asarray(j_star), **FORWARD)

    key_e, perm, bsz, _ = _epoch_plan(jm, key)
    j_val, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, perm[:bsz],
                                                          jax.random.fold_in(key_e, 0))
    draws = _jax_draws(jm, key_e, 0, perm, bsz)
    loss = pm.net.loss_on(draws)
    np.testing.assert_allclose(float(loss), float(j_val), rtol=1e-5)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 materialize_grads=True)))
    g64 = _float64_grads(pm, draws)
    exempt = {n: g.abs().numpy() <= ROUNDING for n, g in g64.items()}
    want = _flat_jax(j_grads)
    for n, g in grads.items():
        units = exempt[n]
        assert np.abs(g.numpy()[units]).max(initial=0.0) <= 1e-6, n
        np.testing.assert_allclose(g.numpy()[~units], want[n][~units], **STEP, err_msg=n)

    wd = pm.weight_decay
    jopt = optax.adamw(pm.learning_rate, weight_decay=wd)
    updates, _ = jopt.update(j_grads, jopt.init(jparams), jparams)
    jnew = _flat_jax(optax.apply_updates(jparams, updates))
    popt = adamw(pm.learning_rate, weight_decay=wd)
    step(params, popt, popt.init(params), pm.net.loss_on(draws))
    for n, p in params.items():
        _held(p.detach().numpy(), jnew[n], n, pm.learning_rate, 1, exempt)


@pytest.mark.parametrize("combiner", ["mul", "review-only", "self-only"])
def test_the_other_combiners_forward_matches(splits, monkeypatch, combiner):
    js, ps = splits
    config = dict(combiner=combiner, predictor="dot" if combiner == "self-only" else "narre")
    jm, _, jparams, _ = _jax_parts(js, config, monkeypatch)
    pm = _port(ps, config)
    j_rep, j_star = jm._node_embeddings(jparams, None)
    with torch.no_grad():
        p_rep, p_star = pm.net.node_embeddings(None)
    np.testing.assert_allclose(p_rep.numpy(), np.asarray(j_rep), **FORWARD)
    np.testing.assert_allclose(p_star.numpy(), np.asarray(j_star), **FORWARD)
    users = np.arange(4)
    jm._cache_inference(jparams)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **FORWARD)


def test_one_epoch_on_the_jax_draws_matches_the_jax_fit(splits):
    js, ps = splits
    jm = J.HypAR(**BASE).fit(js.train_set)
    pm = _port(ps, {})
    rng = np.random.RandomState(SEED)
    jm._init_params(rng, jm._ao_content_embeddings(js.train_set))
    key = jax.random.PRNGKey(rng.randint(2**31))
    key_e, perm, bsz, n_batches = _epoch_plan(jm, key)
    params = pm.net.params
    opt = adamw(pm.learning_rate, weight_decay=pm.weight_decay)
    state = opt.init(params)
    exempt = {}
    for b in range(n_batches):
        draws = _jax_draws(jm, key_e, b, perm, bsz)
        for n, g in _float64_grads(pm, draws).items():
            zero = g.abs().numpy() <= ROUNDING
            exempt[n] = zero if n not in exempt else exempt[n] | zero
        state = step(params, opt, state, pm.net.loss_on(draws))
    want = _flat_jax(jm.params)
    for n, p in params.items():
        _held(p.detach().numpy(), want[n], n, pm.learning_rate, n_batches, exempt)


# ------------------------------------------------------------- scoring --


def test_scores_through_convert_match_jax(splits):
    js, ps = splits
    jm = J.HypAR(**BASE).fit(js.train_set)
    options = ("stemming", "node_dim", "num_heads", "non_linear", "objective",
               "review_aggregator", "predictor", "preference_module", "combiner", "graph_type",
               "embedding_type", "learn_explainability", "learn_method")
    meta = {n: getattr(jm, n) for n in options + ("num_users", "num_items", "uid_map", "iid_map",
                                                  "min_rating", "max_rating", "global_mean")}
    meta["ao_feats"] = np.asarray(jm._ao_feats)
    pm = model_from_params("HypAR", jax.tree_util.tree_map(np.asarray, jm.params), meta,
                           train_set=ps.train_set)
    users = np.array([0, 2, 7, pm.num_users - 1])
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pm.score(2), jm.score(2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.monitor_value(val_set=ps.test_set),
                               jm.monitor_value(val_set=js.test_set), rtol=1e-6)


def test_seeded_fit_with_best_selection_refits_bit_for_bit(splits):
    _, ps = splits
    kw = dict(BASE, num_epochs=3, model_selection="best", early_stopping=2)
    fits = []
    for _ in range(2):
            fits.append(P.HypAR(**kw).fit(ps.train_set, ps.test_set))
    for n, a in fits[0].params.items():
        np.testing.assert_array_equal(a, fits[1].params[n], err_msg=n)
    assert np.isfinite(fits[0].score_batch(np.arange(4))).all()
