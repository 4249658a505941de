"""The port's TransformerRec and BERT4Rec against the JAX package's, on the
CPU, at narrow widths (d 8, one or two blocks, two heads, ``max_len`` 10;
the sessions of ``test_torch_sequential``).

- Bits: the initial parameters of every objective (rtd's discriminator,
  plm's query vector), the Cloze rows, seeded refits in one run and in
  one-epoch chunks, a fit stopped and resumed from its checkpoints.
- Exact: ``_bernoulli_mask`` on the JAX package's uniforms (rows with no,
  one and two valid positions; mask rates 0, 0.3 and 1, so rows with none
  and with all masked); rtd's corruption draw, Gumbel-max on the JAX key's
  uniforms, equal to ``jax.random.categorical``.
- rtol 1e-5 / atol 1e-6: ``_encode`` (causal and not, one and two heads,
  padded rows) and ``_encode_two_stream`` on a permutation mask from the
  JAX package's order uniforms.
- rtol 1e-5 / atol 1e-6 on the loss, rtol 1e-4 / atol 1e-6 on the
  gradients (float32 sums of another order through two blocks and a
  softmax over the sampled columns): one step of every objective (clm at
  'all' and 'last', mlm, plm, rtd; dropout 0 and 0.2, with the JAX
  package's own dropout masks) on the JAX package's draws, through the JAX
  fit's own loss function (captured from ``jax.value_and_grad``).
- rtol 1e-4 / atol 1e-5: one BERT4Rec epoch on the JAX fit's permutation
  and draws against the JAX package's 1-epoch fit.
- Within 1e-6: a JAX fit carried into the port (``model_from_params``)
  scores histories as the JAX model does, each objective.
- Refusals: the constructors' errors, a ``mesh=`` that is no mesh.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu.models as jmodels
from cornac_tpu.models import seq_utils as j_seq
from cornac_tpu.models import transformer_rec as j_tr
from cornac_tpu.utils import get_rng as j_get_rng

import cornac_tpu_torch
import cornac_tpu_torch.models as tmodels
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models import transformer_rec as t_tr
from cornac_tpu_torch.ops.optim import adam, step
from cornac_tpu_torch.utils import checkpoint as ck
from cornac_tpu_torch.utils import get_rng

from test_torch_nn import flatten
from test_torch_sequential import _evals, _histories

cornac_tpu_torch.set_default_device("cpu")

TOL5 = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
V, D, L = 30, 8, 10

OBJECTIVES = {
    "mlm": dict(backbone="bert", objective="mlm"),
    "clm": dict(backbone="gpt2", objective="clm"),
    "clm-last": dict(backbone="gpt2", objective="clm", loss_at="last"),
    "plm": dict(backbone="xlnet", objective="plm"),
    "rtd": dict(backbone="electra", objective="rtd"),
}
NARROW = dict(embedding_dim=D, num_blocks=2, num_heads=2, max_len=L, batch_size=16,
              learning_rate=0.01, n_sample=12, seed=3)


@pytest.fixture(scope="module")
def evals():
    return _evals()


def _kw(name, **over):
    return {**NARROW, **OBJECTIVES[name], **over}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_module(module, tree, tol, what=""):
    for name, value in flatten(tree).items():
        np.testing.assert_allclose(module.get_parameter(name).detach().numpy(), value, **tol,
                                   err_msg=f"{what} {name}")


# ---------------------------------------------------------------- init --
@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_initial_parameters_are_bit_identical(name):
    kw = OBJECTIVES[name]
    args = (V + 2, D, 2, L)
    flags = dict(rtd=kw["objective"] == "rtd", plm=kw["objective"] == "plm")
    tree = j_tr._init_transformer(j_get_rng(4), *args, **flags)
    module = t_tr._init_transformer(get_rng(4), *args, **flags)
    names = flatten(tree)
    assert set(names) == {n for n, _ in module.named_parameters()}
    for key, value in names.items():
        np.testing.assert_array_equal(module.get_parameter(key).detach().numpy(), value, key)


# ---------------------------------------------------------------- masks --
def _valid(seed=0, B=12):
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, 2, 2, 3, L, 5, 1, 7, 4, 2, 9])[:B]
    return (np.arange(L)[None] < lengths[:, None]) & (rng.rand(B, 1) >= 0)


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bernoulli_mask_on_the_jax_uniforms(p, seed):
    valid = _valid()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_tr._bernoulli_mask(key, jnp.asarray(valid), p))
    u = np.asarray(jax.random.uniform(key, valid.shape))
    got = t_tr._bernoulli_mask(torch.from_numpy(u), torch.from_numpy(valid), p).numpy()
    np.testing.assert_array_equal(got, want)
    n_valid = valid.sum(1)
    masked = got.sum(1)
    assert (masked[n_valid > 0] >= 1).all()  # at least one masked
    assert (masked[n_valid > 1] < n_valid[n_valid > 1]).all()  # at least one visible
    assert not got[~valid].any()
    if p == 0.0:  # no draw below the rate: the fallback masks one a row
        np.testing.assert_array_equal(masked, (n_valid > 0).astype(int))
    if p == 1.0:  # every draw below it: one a row unmasked where two are valid
        np.testing.assert_array_equal(masked, np.where(n_valid > 1, n_valid - 1, n_valid))


def test_rtd_corruption_is_the_jax_categorical():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, L, V).astype(np.float32) * 3
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    u = np.asarray(jax.random.uniform(key, logits.shape, minval=np.finfo(np.float32).tiny,
                                      maxval=1.0))
    gumbel = torch.from_numpy(u).log().neg_().log_().neg_()
    got = torch.argmax(torch.from_numpy(logits) + gumbel, dim=-1).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- forward --
def _padded_seq(B=5, seed=30, pad=V, left=False):
    rng = np.random.RandomState(seed)
    lengths = np.array([L, 6, 1, 3, 0])[:B]
    seq = np.full((B, L), pad, np.int64)
    for b, n in enumerate(lengths):
        if n:
            if left:
                seq[b, L - n:] = rng.randint(V, size=n)
            else:
                seq[b, :n] = rng.randint(V, size=n)
    return seq


def _pair(seed=5, rtd=False, plm=False):
    args = (V + 2, D, 2, L)
    return (j_tr._init_transformer(j_get_rng(seed), *args, rtd=rtd, plm=plm),
            t_tr._init_transformer(get_rng(seed), *args, rtd=rtd, plm=plm))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_encode_matches(causal, heads):
    tree, module = _pair()
    for left in (False, True):
        seq = _padded_seq(left=left)
        want = np.asarray(j_tr._encode(tree, jnp.asarray(seq), V, heads, causal))
        got = t_tr._encode(module, torch.from_numpy(seq), V, heads, causal)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL5)
    want = np.asarray(j_tr._encode_scores(tree, jnp.asarray(seq), V, heads, causal, V))
    got = t_tr._encode_scores(module, torch.from_numpy(seq), V, heads, causal, V)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL5)


@pytest.mark.parametrize("heads", [1, 2])
def test_encode_two_stream_matches(heads):
    tree, module = _pair(plm=True)
    seq = _padded_seq()
    valid = seq != V
    key = jax.random.PRNGKey(9)
    k_mask, k_order = jax.random.split(key)
    is_target = np.asarray(j_tr._bernoulli_mask(k_mask, jnp.asarray(valid), 0.3))
    order = np.asarray(jax.random.uniform(k_order, seq.shape))
    # the JAX package's mask, as its loss builds it
    rank = jnp.argsort(jnp.argsort(jnp.asarray(order), axis=1), axis=1)
    perm_index = jnp.where(jnp.asarray(is_target), rank, -1)
    perm_mask = (perm_index[:, :, None] <= perm_index[:, None, :]) & jnp.asarray(is_target)[:, None, :]
    allowed = t_tr._perm_allowed(torch.from_numpy(is_target), torch.from_numpy(order))
    np.testing.assert_array_equal(allowed.numpy(), ~np.asarray(perm_mask))
    want = np.asarray(j_tr._encode_two_stream(tree, jnp.asarray(seq), V, heads, ~perm_mask,
                                              jnp.asarray(is_target)))
    got = t_tr._encode_two_stream(module, torch.from_numpy(seq), V, heads, allowed,
                                  torch.from_numpy(is_target))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL5)


# ------------------------------------------------------------ one step --
class _Captured(Exception):
    pass


def _jax_loss_fn(monkeypatch, kw, train_set):
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
            jmodels.TransformerRec(**kw).fit(train_set)
    return fns[0]


def _jax_drop_masks(k_drop, dropout, sites, shape, fold=None):
    """The keep masks the JAX package's ``make_drop`` draws at ``sites``."""
    if dropout <= 0.0:
        return None
    key = k_drop if fold is None else jax.random.fold_in(k_drop, fold)
    return [torch.from_numpy(np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, i), 1.0 - dropout, shape))) for i in sites]


def _jax_draws(model, key, B, cum, params_j, seq, dropout):
    """The draws of one step of the JAX fit's loss, from its step key, in
    the form ``TransformerRec.loss_on`` takes them."""
    k_mask, k_neg, k_drop, k_corrupt = jax.random.split(key, 4)
    obj = model.objective
    out = {"negs": torch.from_numpy(np.asarray(
        j_seq.sample_negatives(k_neg, jnp.asarray(cum), (model.n_sample,))))}
    blocks = model.num_blocks
    sites = range(1 + (4 if obj == "plm" else 2) * blocks)
    out["drop"] = _jax_drop_masks(k_drop, dropout, sites, (B, L, D))
    if obj != "clm":
        out["mask_u"] = torch.from_numpy(np.asarray(jax.random.uniform(k_mask, (B, L))))
    if obj == "plm":
        out["order_u"] = torch.from_numpy(np.asarray(jax.random.uniform(k_corrupt, (B, L))))
    if obj == "rtd":
        out["corrupt_u"] = torch.from_numpy(np.asarray(jax.random.uniform(
            k_corrupt, (B, L, model.num_items), minval=np.finfo(np.float32).tiny, maxval=1.0)))
        out["drop_disc"] = _jax_drop_masks(k_drop, dropout, sites, (B, L, D), fold=999)
    return out


@pytest.mark.parametrize("name, dropout", [(name, 0.2) for name in sorted(OBJECTIVES)]
                         + [("mlm", 0.0), ("rtd", 0.0)])
def test_one_step_loss_and_gradients_on_the_jax_draws(evals, monkeypatch, name, dropout):
    j_ev, t_ev = evals
    kw = _kw(name, n_epochs=1, dropout=dropout)
    loss_fn = _jax_loss_fn(monkeypatch, kw, j_ev.train_set)
    j0 = jmodels.TransformerRec(**{**kw, "n_epochs": 0}).fit(j_ev.train_set)
    tm = tmodels.TransformerRec(**{**kw, "n_epochs": 0}).fit(t_ev.train_set)
    inputs, targets, mask, bsz = tm.training_rows(t_ev.train_set)
    rows = slice(0, bsz)
    seq, tgt, m = inputs[rows], targets[rows], mask[rows]
    key = jax.random.PRNGKey(21)
    j_val, j_grads = jax.value_and_grad(loss_fn)(j0.params, jnp.asarray(seq), jnp.asarray(tgt),
                                                 jnp.asarray(m), key)
    cum = j_seq.neg_sampling_table(j_ev.train_set, tm.sample_alpha, tm.num_items)
    draws = _jax_draws(tm, key, bsz, cum, j0.params, seq, dropout)
    t_val = tm.loss_on(*(torch.from_numpy(a).long() for a in (seq, tgt)),
                       torch.from_numpy(m), draws)
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL5)
    params = dict(tm.params.named_parameters())
    grads = torch.autograd.grad(t_val, list(params.values()), materialize_grads=True)
    want = flatten(_numpy_tree(j_grads))
    for (pname, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[pname], **GRAD_TOL, err_msg=pname)


def test_cloze_rows_are_the_jax_package_rows(evals):
    """The vectorised Cloze rebuild gives the JAX package's loop's rows."""
    _, t_ev = evals
    tm = tmodels.BERT4Rec(**{k: v for k, v in NARROW.items()}, n_epochs=0)
    tm.fit(t_ev.train_set)
    inputs, _, mask, _ = tm.training_rows(t_ev.train_set)
    _, j_in, j_tgt, j_mask = j_seq.build_session_examples(t_ev.train_set, L)
    pad = tm.num_items
    for b in range(j_in.shape[0]):
        ln = int(j_mask[b].sum())
        want = ([int(j_in[b, 0])] + list(j_tgt[b, :ln]))[-L:]
        assert list(inputs[b, :len(want)]) == want
        assert (inputs[b, len(want):] == pad).all()
        assert mask[b].sum() == len(want)


# ------------------------------------------------------------ one epoch --
def test_one_bert4rec_epoch_on_the_jax_stream_matches_the_jax_fit(evals, monkeypatch):
    j_ev, t_ev = evals
    kw = dict(NARROW, n_epochs=1, dropout=0.1, batch_size=8, num_blocks=1)
    seeds = []
    real = jax.random.PRNGKey
    monkeypatch.setattr(jax.random, "PRNGKey", lambda s: seeds.append(int(s)) or real(s))
    jm = jmodels.BERT4Rec(**kw).fit(j_ev.train_set)
    monkeypatch.undo()
    tm = tmodels.BERT4Rec(**{**kw, "n_epochs": 0}).fit(t_ev.train_set)
    inputs, targets, mask, bsz = tm.training_rows(t_ev.train_set)
    cum = j_seq.neg_sampling_table(j_ev.train_set, tm.sample_alpha, tm.num_items)
    ekey = jax.random.fold_in(jax.random.fold_in(real(seeds[-1]), 0), 0)
    order = np.asarray(jax.random.permutation(ekey, inputs.shape[0]))
    params = dict(tm.params.named_parameters())
    opt = adam(kw["learning_rate"])
    state = opt.init(params)
    for b in range(inputs.shape[0] // bsz):
        idx = order[b * bsz:(b + 1) * bsz]
        seq = inputs[idx]
        draws = _jax_draws(tm, jax.random.fold_in(ekey, b), bsz, cum, None, seq, kw["dropout"])
        loss = tm.loss_on(torch.from_numpy(seq).long(), torch.from_numpy(targets[idx]).long(),
                          torch.from_numpy(mask[idx]), draws)
        state = step(params, opt, state, loss)
    _assert_module(tm.params, _numpy_tree(jm.params), dict(rtol=1e-4, atol=1e-5))


# ------------------------------------------------------------ converted --
@pytest.fixture(scope="module")
def jax_fits(evals):
    """A trained BERT4Rec (one epoch) and every objective's fitted initial
    state (0 epochs: no epoch program to compile), its output biases
    moved off zero."""
    j_ev, _ = evals
    fits = {}
    for name in OBJECTIVES:
        jm = jmodels.TransformerRec(**_kw(name, n_epochs=int(name == "mlm"), num_blocks=1))
        jm.fit(j_ev.train_set)
        if name != "mlm":
            bias = np.random.RandomState(1).randn(*jm.params["out_b"].shape).astype(np.float32)
            jm.params["out_b"] = jnp.asarray(0.1 * bias)
        fits[name] = jm
    return fits


META = ("backbone", "objective", "loss_at", "embedding_dim", "max_len", "num_blocks",
        "num_heads")


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_converted_fits_score_histories_as_jax(evals, jax_fits, name):
    _, t_ev = evals
    jm = jax_fits[name]
    meta = {k: getattr(jm, k) for k in META}
    meta.update(num_users=jm.num_users, num_items=jm.num_items, uid_map=jm.uid_map,
                iid_map=jm.iid_map, min_rating=jm.min_rating, max_rating=jm.max_rating,
                global_mean=jm.global_mean)
    tm = model_from_params("TransformerRec", _numpy_tree(jm.params), meta, device="cpu")
    users, hist = _histories(t_ev)
    np.testing.assert_allclose(tm.score_history_batch(users, hist),
                               jm.score_history_batch(users, hist), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.score(users[0], hist[0]), jm.score(users[0], hist[0]),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- bits --
def _t_params(model):
    return {k: v.detach().numpy().copy() for k, v in model.params.state_dict().items()}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_seeded_fits_in_one_run_and_in_chunks_are_identical(evals, name):
    _, t_ev = evals
    kw = _kw(name, n_epochs=2, dropout=0.2, num_blocks=1)
    a = _t_params(tmodels.TransformerRec(**kw).fit(t_ev.train_set))
    b = _t_params(tmodels.TransformerRec(**kw, verbose=True).fit(t_ev.train_set))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_resumed_fit_equals_uninterrupted(tmp_path, evals):
    _, t_ev = evals
    kw = dict(NARROW, n_epochs=3, dropout=0.2, num_blocks=1, model_selection="best",
              val_eval_every=1)
    straight = _t_params(tmodels.BERT4Rec(**kw).fit(t_ev.train_set, t_ev.val_set))
    tmodels.BERT4Rec(**{**kw, "n_epochs": 1}).enable_checkpointing(tmp_path, every=1).fit(
        t_ev.train_set, t_ev.val_set)
    resumed = _t_params(tmodels.BERT4Rec(**kw).enable_checkpointing(tmp_path, every=1).fit(
        t_ev.train_set, t_ev.val_set))
    assert ck.CheckpointManager(tmp_path).all_steps() == [1, 2, 3]
    for key in straight:
        np.testing.assert_array_equal(resumed[key], straight[key], err_msg=key)


# ------------------------------------------------------------- refusals --
def test_constructor_errors_match_the_jax_package():
    for pkg in (jmodels, tmodels):
        for bad in (dict(backbone="nope"), dict(objective="cloze"), dict(loss_at="first"),
                    dict(loss="hinge"), dict(objective="mlm", backbone="gpt2"),
                    dict(objective="rtd", backbone="gpt2"), dict(objective="plm", backbone="gpt2"),
                    dict(model_selection="every")):
            with pytest.raises(ValueError):
                pkg.TransformerRec(**bad)
        # clm switches the backbone to gpt2 silently
        assert pkg.TransformerRec(objective="clm", backbone="bert").backbone == "gpt2"
        pkg.TransformerRec(backbone="xlnet", objective="plm")
        pkg.TransformerRec(backbone="electra", objective="rtd")
        assert pkg.BERT4Rec().objective == "mlm" and pkg.BERT4Rec().backbone == "bert"


@pytest.mark.parametrize("cls", ["TransformerRec", "BERT4Rec"])
def test_mesh_is_refused(cls):
    # mesh= is ported (tests/test_torch_parallel_sequences.py): anything but
    # a parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tmodels, cls)(mesh=object())


def test_the_card_is_the_default_device(monkeypatch):
    """Without a device asked for, the model trains on the card, and
    without one it raises."""
    monkeypatch.setattr(cornac_tpu_torch.device, "_default", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.BERT4Rec()._device()
    assert tmodels.BERT4Rec(device="cpu")._device() == torch.device("cpu")


# ------------------------------------------------- the device ranking path --
class _HostOnly:
    """A model's host scorer alone: the evaluation's host ranking path."""

    def __init__(self, model):
        self.score_history_batch = model.score_history_batch


class _Tied:
    """A model's scores rounded to a coarse grid: many ties on the device
    path."""

    def __init__(self, model):
        self.model = model

    def score_history_batch_device(self, users, histories):
        return torch.round(self.model.score_history_batch_device(users, histories) * 4) / 4

    def score_history_batch(self, users, histories):
        return self.score_history_batch_device(users, histories).numpy().astype(np.float64)


@pytest.mark.parametrize("mode, user_based", [("last", False), ("next", False), ("next", True)])
def test_next_item_eval_ranks_on_the_device_as_on_the_host(evals, mode, user_based):
    """The evaluation's device path (the context ranks the scores where
    they are: each target's rank alone, or with the tie counts AUC reads)
    gives the host path's metrics, exactly, ties included."""
    from cornac_tpu_torch.eval_methods.next_item_evaluation import ranking_eval
    from cornac_tpu_torch.metrics import AUC, MRR, NDCG, HitRatio, Recall

    _, t_ev = evals
    model = tmodels.BERT4Rec(**dict(NARROW, n_epochs=1, num_blocks=1)).fit(t_ev.train_set)
    for metrics, scorer in itertools.product(
            ([MRR(), HitRatio(k=5), NDCG(k=5), Recall(k=3)], [MRR(), AUC()]),
            (model, _Tied(model))):
        got = ranking_eval(scorer, metrics, t_ev.train_set, t_ev.test_set, user_based=user_based,
                           mode=mode)
        want = ranking_eval(_HostOnly(scorer), metrics, t_ev.train_set, t_ev.test_set,
                            user_based=user_based, mode=mode)
        assert got[0] == want[0]
        assert [dict(b) for b in got[1]] == [dict(b) for b in want[1]]
