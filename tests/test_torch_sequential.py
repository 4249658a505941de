"""The port's next-item family against the JAX package's, on the CPU.

- Byte for byte: ``SequentialDataset`` (maps, sessions, the per-user and
  chronological views, the statistics, the seeded iterators) from SIT,
  USIT, SITJson and USITJson tuples.
- Exact: ``NextItemEvaluation``'s splits (``from_splits``,
  ``from_timestamps``, ``leave_last_out``) and SPop's scores.
- Within 1e-6: the next-item ``ranking_eval`` on a fixed scorer (modes
  'last' and 'next', session- and user-averaged); the four losses and
  ``batch_loss`` (every loss kind, with output biases and the logQ
  correction) on given negatives; the converted FPMC, GRU4Rec and SASRec
  (``convert.model_from_params``) scoring histories.
- rtol 1e-5 / atol 1e-6: the transformer blocks (a fully masked query row
  included), GRU4Rec's states over 8 left-padded steps, SASRec's states.
- rtol 1e-4 / atol 1e-6: one training step of GRU4Rec (adagrad with and
  without momentum) and of SASRec (Adam, betas 0.9 / 0.98) on the JAX
  package's own negatives, dropout 0.
- rtol 1e-5: one FPMC epoch on the JAX package's own draws.
- A ``GridSearch`` over SPop under ``NextItemEvaluation``: the same best
  point, the trials within 1e-4.
- Bits: seeded refits, and GRU4Rec and SASRec stopped and resumed from
  their checkpoints give the uninterrupted fit.
- Refusals: ``mesh=`` other than a ``parallel.make_mesh`` mesh.

Whole fits draw other streams than JAX's and are held on quality on the
card (``chip_smoke.py`` phase 12f, bands from ``tools/quality_bands.py``).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.hyperopt as jhyper
import cornac_tpu.metrics as jmetrics
import cornac_tpu.models as jmodels
from cornac_tpu.engine import nn as jnn
from cornac_tpu.eval_methods import next_item_evaluation as j_nie
from cornac_tpu.models import fpmc as j_fpmc, gru4rec as j_gru, sasrec as j_sas
from cornac_tpu.models import seq_utils as j_seq
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu.utils.init_utils import xavier_uniform as j_xavier

import cornac_tpu_torch
import cornac_tpu_torch.data as tdata
import cornac_tpu_torch.eval_methods as teval
import cornac_tpu_torch.hyperopt as thyper
import cornac_tpu_torch.metrics as tmetrics
import cornac_tpu_torch.models as tmodels
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.engine import nn as tnn
from cornac_tpu_torch.eval_methods import next_item_evaluation as t_nie
from cornac_tpu_torch.models import fpmc as t_fpmc, gru4rec as t_gru, sasrec as t_sas
from cornac_tpu_torch.models import seq_utils as t_seq
from cornac_tpu_torch.ops.optim import adagrad_m, adam, step
from cornac_tpu_torch.utils import checkpoint as ck
from cornac_tpu_torch.utils import get_rng
from cornac_tpu_torch.utils.init_utils import xavier_uniform as t_xavier

from test_torch_nn import flatten

cornac_tpu_torch.set_default_device("cpu")

TOL6 = dict(rtol=1e-6, atol=1e-6)
TOL5 = dict(rtol=1e-5, atol=1e-6)
TOL4 = dict(rtol=1e-4, atol=1e-6)


def gen_sessions(n_sessions=90, n_items=40, n_users=15, seed=7):
    """Block-structured Markov sessions as USIT tuples (the generator of
    ``benchmarks/head_to_head_seq.py`` at a small size)."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    n_blocks = 5
    per = n_items // n_blocks
    for s in range(n_sessions):
        u = rng.randint(n_users)
        block = rng.randint(n_blocks) * per
        x = rng.randint(per)
        for _ in range(rng.randint(2, 8)):
            rows.append((f"u{u}", f"s{s}", f"i{block + x}", t))
            t += 1
            x = (x + 1) % per if rng.rand() < 0.8 else rng.randint(per)
    return rows


ROWS = gen_sessions()


def _split(rows=ROWS, frac=(0.7, 0.85)):
    sids = list(dict.fromkeys(t[1] for t in rows))
    a, b = (sids[int(len(sids) * f)] for f in frac)
    order = {s: k for k, s in enumerate(sids)}
    train = [t for t in rows if order[t[1]] < order[a]]
    val = [t for t in rows if order[a] <= order[t[1]] < order[b]]
    test = [t for t in rows if order[t[1]] >= order[b]]
    return train, val, test


def _evals(mode="last", exclude_unknowns=True, **kw):
    train, val, test = _split()
    return tuple(pkg.NextItemEvaluation.from_splits(
        train_data=train, test_data=test, val_data=val, fmt="USIT",
        exclude_unknowns=exclude_unknowns, seed=123, mode=mode, **kw) for pkg in (jeval, teval))


@pytest.fixture(scope="module")
def evals():
    return _evals()


# ------------------------------------------------------ SequentialDataset --
def _in_fmt(fmt):
    if fmt == "USIT":
        return ROWS
    if fmt == "SIT":
        return [(s, i, t) for _, s, i, t in ROWS]
    if fmt == "USITJson":
        return [(u, s, i, t, {"k": t % 3}) for u, s, i, t in ROWS]
    return [(s, i, t, {"k": t % 3}) for _, s, i, t in ROWS]


def assert_same_sequential(a, b):
    for attr in ("num_users", "num_items", "num_sessions", "max_session_size",
                 "min_session_size", "avg_session_size", "num_ratings"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for attr in ("uid_map", "iid_map", "sid_map"):
        assert list(getattr(a, attr).items()) == list(getattr(b, attr).items()), attr
    for x, y in zip(a.uir_tuple, b.uir_tuple):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.session_indices, b.session_indices)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert a.extra_data == b.extra_data
    assert a.session_ids == b.session_ids
    assert list(a.sessions.items()) == list(b.sessions.items())
    assert {int(k): v for k, v in a.user_session_data.items()} == \
        {int(k): v for k, v in b.user_session_data.items()}


@pytest.mark.parametrize("fmt", ["SIT", "USIT", "SITJson", "USITJson"])
def test_sequential_dataset_is_byte_identical(fmt):
    j = jdata.SequentialDataset.build(_in_fmt(fmt), fmt=fmt, seed=1)
    t = tdata.SequentialDataset.build(_in_fmt(fmt), fmt=fmt, seed=1)
    assert_same_sequential(j, t)
    chrono = lambda d: {int(k): (list(map(int, s)), list(map(int, ts)))  # noqa: E731
                        for k, (s, ts) in d.chrono_user_session_data.items()}
    assert chrono(j) == chrono(t)
    assert j.num_batches(7) == t.num_batches(7)
    for jb, tb in zip(j.si_iter(batch_size=7, shuffle=True), t.si_iter(batch_size=7, shuffle=True)):
        np.testing.assert_array_equal(jb[0], tb[0])
        assert jb[1] == tb[1]
        assert [list(map(int, s)) for s in jb[2]] == [list(map(int, s)) for s in tb[2]]
    jb = list(j.usi_iter(batch_size=4, shuffle=True))
    tb = list(t.usi_iter(batch_size=4, shuffle=True))
    assert len(jb) == len(tb)
    for x, y in zip(jb, tb):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1:3] == y[1:3]


# ------------------------------------------------------ NextItemEvaluation --
def assert_same_splits(j, t):
    for name in ("train_set", "test_set", "val_set"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert_same_sequential(a, b)
    assert list(j.global_uid_map.items()) == list(t.global_uid_map.items())
    assert list(j.global_iid_map.items()) == list(t.global_iid_map.items())
    assert list(j.global_sid_map.items()) == list(t.global_sid_map.items())
    assert j.total_sessions == t.total_sessions


@pytest.mark.parametrize("exclude_unknowns", [True, False])
def test_from_splits_is_exact(exclude_unknowns):
    assert_same_splits(*_evals(exclude_unknowns=exclude_unknowns))


def test_from_timestamps_and_leave_last_out_are_exact():
    ts = sorted(t[3] for t in ROWS)
    kw = dict(fmt="USIT", seed=3, mode="next")
    j = jeval.NextItemEvaluation.from_timestamps(ROWS, ts[int(len(ts) * 0.8)],
                                                 val_timestamp=ts[int(len(ts) * 0.6)], **kw)
    t = teval.NextItemEvaluation.from_timestamps(ROWS, ts[int(len(ts) * 0.8)],
                                                 val_timestamp=ts[int(len(ts) * 0.6)], **kw)
    assert_same_splits(j, t)
    uirt = [(u, i, 1.0, t) for u, _, i, t in ROWS]
    assert_same_splits(jeval.NextItemEvaluation.leave_last_out(uirt, seed=3),
                       teval.NextItemEvaluation.leave_last_out(uirt, seed=3))
    with pytest.raises(ValueError, match="strictly"):
        teval.NextItemEvaluation.from_timestamps(ROWS, 10, val_timestamp=10, **kw)


def _fixed_scorer(base):
    class Fixed(base.NextItemRecommender):
        """Deterministic history scores: a fixed wave plus the history's
        item counts."""

        def __init__(self):
            super().__init__("Fixed", trainable=False)

        def score(self, user_idx, history_items, **kwargs):
            n = self.total_items
            row = np.cos(np.arange(n) * 0.37 + len(history_items) + 0.1 * user_idx)
            return row + 0.5 * np.bincount(np.asarray(history_items, int), minlength=n)[:n]

    return Fixed()


def _metrics(pkg):
    return [pkg.MRR(), pkg.NDCG(k=5), pkg.HitRatio(k=5), pkg.Recall(k=5), pkg.AUC()]


@pytest.mark.parametrize("mode, user_based", [("last", False), ("next", False), ("next", True)])
def test_ranking_eval_on_a_fixed_scorer(evals, mode, user_based):
    (j_ev, t_ev) = evals
    jm, tm = _fixed_scorer(jmodels), _fixed_scorer(tmodels)
    jm.fit(j_ev.train_set)
    tm.fit(t_ev.train_set)
    j_avg, j_per = j_nie.ranking_eval(jm, _metrics(jmetrics), j_ev.train_set, j_ev.test_set,
                                      user_based=user_based, mode=mode)
    t_avg, t_per = t_nie.ranking_eval(tm, _metrics(tmetrics), t_ev.train_set, t_ev.test_set,
                                      user_based=user_based, mode=mode)
    np.testing.assert_allclose(t_avg, j_avg, **TOL6)
    for a, b in zip(j_per, t_per):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(b[key], a[key], **TOL6)


def _histories(ev):
    users, hist = [], []
    for [sid], [mapped], [items] in ev.test_set.si_iter(batch_size=1):
        for pos in range(1, len(items)):
            users.append(int(ev.test_set.uir_tuple[0][mapped[0]]))
            hist.append([int(x) for x in items[:pos]])
    return np.asarray(users), hist


@pytest.mark.parametrize("use_session_popularity", [True, False])
def test_spop_scores_and_results_are_exact(evals, use_session_popularity):
    j_ev, t_ev = evals
    jm = jmodels.SPop(use_session_popularity=use_session_popularity).fit(j_ev.train_set)
    tm = tmodels.SPop(use_session_popularity=use_session_popularity).fit(t_ev.train_set)
    users, hist = _histories(t_ev)
    np.testing.assert_array_equal(tm.score_history_batch(users, hist),
                                  jm.score_history_batch(users, hist))
    np.testing.assert_array_equal(tm.score(0, hist[3]), jm.score(0, hist[3]))
    j_res = j_ev.evaluate(jm, _metrics(jmetrics), user_based=False)[0].metric_avg_results
    t_res = t_ev.evaluate(tm, _metrics(tmetrics), user_based=False)[0].metric_avg_results
    for key in j_res:
        if "(s)" not in key:
            assert t_res[key] == j_res[key], key


def test_grid_search_over_spop_matches(evals):
    j_ev, t_ev = evals
    space = lambda pkg: [pkg.Discrete("use_session_popularity", [True, False])]  # noqa: E731
    js = jhyper.GridSearch(jmodels.SPop(), space(jhyper), jmetrics.MRR(), j_ev)
    ts = thyper.GridSearch(tmodels.SPop(), space(thyper), tmetrics.MRR(), t_ev)
    js.fit(j_ev.train_set, j_ev.val_set)
    ts.fit(t_ev.train_set, t_ev.val_set)
    assert ts.best_params == js.best_params
    assert [p for p, _ in ts.trial_results] == [p for p, _ in js.trial_results]
    np.testing.assert_allclose([s for _, s in ts.trial_results],
                               [s for _, s in js.trial_results], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ losses --
def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def test_the_four_losses_match():
    logits, targets = _rand((3, 5, 11), 0), np.random.RandomState(1).randint(11, size=(3, 5))
    mask = (np.random.RandomState(2).rand(3, 5) < 0.7).astype(np.float32)
    j = j_seq.xe_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    t = t_seq.xe_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask))
    np.testing.assert_allclose(float(t), float(j), **TOL6)
    pos, neg = _rand((4, 6), 3), _rand((4, 6, 9), 4)
    nmask = (np.random.RandomState(5).rand(4, 6, 9) < 0.8).astype(np.float32)
    nmask[..., 0] = 1.0
    for jf, tf, args in ((j_seq.bpr_max_loss, t_seq.bpr_max_loss, (pos, neg, nmask)),
                         (j_seq.top1_loss, t_seq.top1_loss, (pos, neg, nmask))):
        np.testing.assert_allclose(tf(*map(torch.from_numpy, args)).numpy(),
                                   np.asarray(jf(*map(jnp.asarray, args))), **TOL6)
    counts = np.random.RandomState(6).randint(1, 50, size=(4, 6, 9)).astype(np.float32)
    j = j_seq.sampled_xe_logq(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(counts), 400.0,
                              jnp.asarray(nmask))
    t = t_seq.sampled_xe_logq(torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.from_numpy(counts), 400.0, torch.from_numpy(nmask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL6)


@pytest.mark.parametrize("kind", j_seq.SUPPORTED_LOSSES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_batch_loss_matches_on_given_negatives(kind, with_bias, B=4, L=5, H=6, V=30, N=7):
    states, out_emb = _rand((B, L, H), 10, 0.5), _rand((V, H), 11, 0.5)
    out_b = _rand((V,), 12, 0.1) if with_bias else None
    targets = np.random.RandomState(13).randint(V, size=(B, L))
    mask = (np.random.RandomState(14).rand(B, L) < 0.75).astype(np.float32)
    negs = np.random.RandomState(15).randint(V, size=N)
    log_p0 = np.log(np.random.RandomState(16).dirichlet(np.ones(V))).astype(np.float32)
    kw = dict(logq=0.5, log_p0=log_p0, sample_alpha=0.75) if with_bias else {}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    j = j_seq.batch_loss(kind, jnp.asarray(states), jnp.asarray(out_emb),
                         None if out_b is None else jnp.asarray(out_b), jnp.asarray(targets),
                         jnp.asarray(mask), jnp.asarray(negs), **jkw)
    t = t_seq.batch_loss(kind, torch.from_numpy(states), torch.from_numpy(out_emb),
                         None if out_b is None else torch.from_numpy(out_b),
                         torch.from_numpy(targets), torch.from_numpy(mask),
                         torch.from_numpy(negs), **tkw)
    np.testing.assert_allclose(float(t), float(j), **TOL6)


def test_session_examples_and_padding_match(evals):
    j_ev, t_ev = evals
    for a, b in zip(j_seq.build_session_examples(j_ev.train_set, 6),
                    t_seq.build_session_examples(t_ev.train_set, 6)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _, hist = _histories(t_ev)
    for a, b in zip(j_seq.pad_histories(hist, 4, pad_value=9), t_seq.pad_histories(hist, 4, 9)):
        np.testing.assert_array_equal(a, b)
    mask = j_seq.build_session_examples(j_ev.train_set, 6)[3]
    assert t_seq.sessions_per_batch(64, mask, 40) == j_seq.sessions_per_batch(64, mask, 40)
    np.testing.assert_array_equal(
        t_seq.neg_sampling_table(t_ev.train_set, 0.5, 45, "cpu").numpy(),
        np.asarray(j_seq.neg_sampling_table(j_ev.train_set, 0.5, 45)))


# ------------------------------------------------------ transformer blocks --
def _block_pair(d=8, seed=4):
    """The same seeded block's parameters in both packages."""
    j_rng, rng = j_get_rng(seed), get_rng(seed)
    tree = jnn.init_transformer_block(lambda shape: jnp.asarray(j_xavier(shape, j_rng)), d)
    blk = tnn.init_transformer_block(lambda shape: t_xavier(shape, rng), d)
    return tree, blk


def test_transformer_blocks_match(B=3, L=6, d=8):
    tree, blk = _block_pair(d)
    for name, value in flatten(tree).items():
        np.testing.assert_array_equal(getattr(blk, name).detach().numpy(), value, err_msg=name)
    x, q = _rand((B, L, d), 20), _rand((B, L, d), 21)
    g, b = _rand((d,), 22), _rand((d,), 23)
    np.testing.assert_allclose(
        tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy(),
        np.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))), **TOL5)
    mask = np.tril(np.ones((L, L), bool))[None].repeat(B, 0)
    mask[1, :, :3] = False  # left padding: queries 0-2 of row 1 see no key
    mask[2] = False  # a fully padded row: uniform softmax, no NaN
    for heads in (1, 2):
        j = jnn.block_attention(tree, jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), heads,
                                jnn.make_drop(0.0, None), 1)
        t = tnn.block_attention(blk, torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(mask), heads, tnn.make_drop(0.0, None), 1)
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL5)
    for jact, tact in ((jax.nn.gelu, tnn.ACTIVATIONS["gelu"]), (jax.nn.relu, torch.relu)):
        j = jnn.block_ffn(tree, jnp.asarray(x), jnn.make_drop(0.0, None), 2, act=jact)
        t = tnn.block_ffn(blk, torch.from_numpy(x), tnn.make_drop(0.0, None), 2, act=tact)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL5)
    gen = torch.Generator().manual_seed(0)
    dropped = tnn.make_drop(0.5, gen)(torch.ones(400), 0)
    assert set(dropped.unique().tolist()) == {0.0, 2.0}


# ---------------------------------------------------------------- GRU4Rec --
def _left_padded(B=5, L=8, V=30, seed=30):
    rng = np.random.RandomState(seed)
    lengths = np.minimum(np.array([8, 5, 1, 3, 0])[:B], L)
    seq = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.float32)
    for b, n in enumerate(lengths):
        if n:
            seq[b, L - n:] = rng.randint(V, size=n)
            mask[b, L - n:] = 1.0
    return seq, mask


@pytest.mark.parametrize("constrained, layers", [(True, [8]), (False, [8, 6])])
def test_gru_init_and_states_match(constrained, layers, V=30):
    tree = j_gru._init_gru(j_get_rng(5), V, layers, 0, constrained)
    module = t_gru._init_gru(get_rng(5), V, layers, 0, constrained)
    for name, value in flatten(tree).items():
        np.testing.assert_array_equal(module.get_parameter(name).detach().numpy(), value, name)
    seq, mask = _left_padded(V=V)
    j = j_gru._gru_states(tree, jnp.asarray(seq), jnp.asarray(mask))
    t = t_gru._gru_states(module, torch.from_numpy(seq).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL5)


def _jax_negs(n, V, seed=40):
    cum = jnp.asarray(np.cumsum(np.full(V, 1.0 / V)), jnp.float32)
    return np.asarray(j_seq.sample_negatives(jax.random.PRNGKey(seed), cum, (n,)))


def _assert_module(module, tree, tol):
    for name, value in flatten(tree).items():
        np.testing.assert_allclose(module.get_parameter(name).detach().numpy(), value, **tol,
                                   err_msg=name)


@pytest.mark.parametrize("loss, momentum", [("cross-entropy", 0.0), ("bpr-max", 0.3)])
def test_gru_one_training_step_matches(loss, momentum, V=30, lr=0.05):
    tree = j_gru._init_gru(j_get_rng(6), V, [8], 0, True)
    module = t_gru._init_gru(get_rng(6), V, [8], 0, True)
    rng = np.random.RandomState(7)
    seq = rng.randint(V, size=(4, 6)).astype(np.int32)
    tgt = rng.randint(V, size=(4, 6)).astype(np.int32)
    m = (np.arange(6)[None] < np.array([[6], [3], [5], [1]])).astype(np.float32)
    negs = _jax_negs(9, V)

    def j_loss(p):
        states = j_gru._gru_states(p, jnp.asarray(seq), step_mask=jnp.asarray(m))
        return j_seq.batch_loss(loss, states, p["out_emb"], p["out_b"], jnp.asarray(tgt),
                                jnp.asarray(m), jnp.asarray(negs))

    j_val, grads = jax.value_and_grad(j_loss)(tree)
    opt = j_seq.adagrad_m(lr, momentum)
    updates, _ = opt.update(grads, opt.init(tree), tree)
    want = optax.apply_updates(tree, updates)

    states = t_gru._gru_states(module, torch.from_numpy(seq).long(),
                               step_mask=torch.from_numpy(m))
    t_val = t_seq.batch_loss(loss, states, module.out_emb, module.out_b,
                             torch.from_numpy(tgt), torch.from_numpy(m), torch.from_numpy(negs))
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL4)
    params = dict(module.named_parameters())
    t_opt = adagrad_m(lr, momentum)
    step(params, t_opt, t_opt.init(params), t_val)
    _assert_module(module, want, TOL4)


# ----------------------------------------------------------------- SASRec --
def test_sasrec_init_and_states_match(V=25, d=8, L=8):
    tree = j_sas._init_sasrec(j_get_rng(8), V, d, 2, L, True, True)
    module = t_sas._init_sasrec(get_rng(8), V, d, 2, L, True, True)
    for name, value in flatten(tree).items():
        np.testing.assert_array_equal(module.get_parameter(name).detach().numpy(), value, name)
    seq, mask = _left_padded(V=V, L=L)
    seq[mask == 0] = V  # the padding id
    for heads in (1, 2):
        j = j_sas._sasrec_states(tree, jnp.asarray(seq), V, heads)
        t = t_sas._sasrec_states(module, torch.from_numpy(seq).long(), V, heads)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL5)
        j = j_sas._sasrec_scores(tree, jnp.asarray(seq), V, heads, V)
        t = t_sas._sasrec_scores(module, torch.from_numpy(seq).long(), V, heads, V)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL5)


@pytest.mark.parametrize("loss", ["ce", "bpr"])
def test_sasrec_one_training_step_matches(loss, V=25, d=8, L=6, lr=0.01, l2=0.01):
    tree = j_sas._init_sasrec(j_get_rng(9), V, d, 2, L, True, False)
    module = t_sas._init_sasrec(get_rng(9), V, d, 2, L, True, False)
    seq, mask = _left_padded(B=4, L=L, V=V)
    seq[mask == 0] = V
    tgt = np.where(mask > 0, np.random.RandomState(3).randint(V, size=mask.shape), 0)
    negs = _jax_negs(8, V, seed=41)

    def j_loss(p):
        states = j_sas._sasrec_states(p, jnp.asarray(seq), V, 1, dropout=0.0, drop_key=None)
        out = j_seq.batch_loss(loss, states, p["emb"], None, jnp.asarray(tgt), jnp.asarray(mask),
                               jnp.asarray(negs))
        return out + l2 * (jnp.sum(p["emb"] ** 2) + jnp.sum(p["pos"] ** 2))

    j_val, grads = jax.value_and_grad(j_loss)(tree)
    opt = optax.adam(lr, b1=0.9, b2=0.98)
    updates, _ = opt.update(grads, opt.init(tree), tree)
    want = optax.apply_updates(tree, updates)

    states = t_sas._sasrec_states(module, torch.from_numpy(seq).long(), V, 1)
    t_val = t_seq.batch_loss(loss, states, module.emb, None, torch.from_numpy(tgt),
                             torch.from_numpy(mask), torch.from_numpy(negs))
    t_val = t_val + l2 * (torch.sum(module.emb ** 2) + torch.sum(module.pos ** 2))
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL4)
    params = dict(module.named_parameters())
    t_opt = adam(lr, b1=0.9, b2=0.98)
    step(params, t_opt, t_opt.init(params), t_val)
    _assert_module(module, want, TOL4)


# ------------------------------------------------------------------- FPMC --
def test_fpmc_one_epoch_on_the_jax_draws_matches(evals, d=6, lr=0.05, reg=0.01, bsz=16):
    j_ev, _ = evals
    train = j_ev.train_set
    users, prevs, nexts = [], [], []
    for sid, idx in train.sessions.items():
        items = [int(train.uir_tuple[1][i]) for i in idx]
        for a, b in zip(items[:-1], items[1:]):
            users.append(int(train.uir_tuple[0][idx[0]]))
            prevs.append(a)
            nexts.append(b)
    n, V, U = len(users), train.num_items, train.num_users
    n_total = n + (-n) % bsz
    rng = np.random.RandomState(0)
    tables = {name: (rng.randn(rows, d) * 0.1).astype(np.float32)
              for name, rows in zip(t_fpmc.TABLES, (U, V, V, V))}
    key = jax.random.PRNGKey(17)
    k_pos, k_neg = jax.random.split(jax.random.fold_in(key, 0))
    pos_idx = np.asarray(jax.random.randint(k_pos, (n_total,), 0, n))
    neg_items = np.asarray(jax.random.randint(k_neg, (n_total,), 0, V))
    want, _ = j_fpmc._fpmc_epochs(
        {k: jnp.asarray(v) for k, v in tables.items()}, key,
        *(jnp.asarray(a, jnp.int32) for a in (users, prevs, nexts)),
        jnp.float32(lr), jnp.float32(reg), batch_size=bsz, num_items=V, n_epochs=jnp.int32(1))
    got = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    t_fpmc._fpmc_epoch(got, *(torch.as_tensor(a, dtype=torch.int64) for a in (users, prevs, nexts)),
                       torch.from_numpy(pos_idx).long(), torch.from_numpy(neg_items).long(), n,
                       lr, reg, bsz)
    for name in t_fpmc.TABLES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


# ------------------------------------------------------- converted models --
J_FITS = {
    "FPMC": dict(embedding_dim=6, n_epochs=2, batch_size=16, seed=3),
    "GRU4Rec": dict(layers=[8], batch_size=24, n_epochs=1, n_sample=16, max_len=8, seed=3),
    "SASRec": dict(embedding_dim=8, num_blocks=1, batch_size=24, n_epochs=1, n_sample=16,
                   max_len=8, use_biases=True, seed=3),
}
META = {"FPMC": ("embedding_dim",),
        "GRU4Rec": ("layers", "max_len", "embedding", "constrained_embedding"),
        "SASRec": ("embedding_dim", "max_len", "num_blocks", "num_heads", "use_pos_emb",
                   "use_biases")}


def _meta(model, options):
    meta = {name: getattr(model, name) for name in options}
    meta.update(num_users=model.num_users, num_items=model.num_items,
                uid_map=model.uid_map, iid_map=model.iid_map, min_rating=model.min_rating,
                max_rating=model.max_rating, global_mean=model.global_mean)
    return meta


@pytest.fixture(scope="module")
def jax_fits(evals):
    j_ev, _ = evals
    return {name: getattr(jmodels, name)(**kw).fit(j_ev.train_set) for name, kw in J_FITS.items()}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(J_FITS))
def test_converted_models_score_histories_as_jax(evals, jax_fits, name):
    _, t_ev = evals
    jm = jax_fits[name]
    tm = model_from_params(name, _numpy_tree(jm.params), _meta(jm, META[name]), device="cpu")
    users, hist = _histories(t_ev)
    np.testing.assert_allclose(tm.score_history_batch(users, hist),
                               jm.score_history_batch(users, hist), **TOL6)
    np.testing.assert_allclose(tm.score(users[0], hist[0]), jm.score(users[0], hist[0]), **TOL6)


# ------------------------------------------------------------------- bits --
T_FITS = {
    "FPMC": dict(embedding_dim=6, n_epochs=3, batch_size=16, seed=3),
    "FPMC-general": dict(embedding_dim=6, loss="bpr-max", momentum=0.2, n_sample=8, n_epochs=3,
                         batch_size=16, seed=3),
    "GRU4Rec": dict(layers=[8], batch_size=24, n_epochs=3, n_sample=16, max_len=8,
                    dropout_p_hidden=0.2, logq=0.5, seed=3),
    "SASRec": dict(embedding_dim=8, num_blocks=1, batch_size=24, n_epochs=3, n_sample=16,
                   max_len=8, dropout=0.2, seed=3, model_selection="best", val_eval_every=1),
}


def _t_params(model):
    if isinstance(model.params, dict):
        return {k: v.detach().numpy().copy() for k, v in model.params.items()}
    return {k: v.detach().numpy().copy() for k, v in model.params.state_dict().items()}


def _make(name, **over):
    return getattr(tmodels, name.split("-")[0])(**{**T_FITS[name], **over})


@pytest.mark.parametrize("name", sorted(T_FITS))
def test_seeded_refits_are_identical(evals, name):
    _, t_ev = evals
    a = _t_params(_make(name).fit(t_ev.train_set, t_ev.val_set))
    b = _t_params(_make(name, verbose=True).fit(t_ev.train_set, t_ev.val_set))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("name", ["GRU4Rec", "SASRec"])
def test_resumed_fit_equals_uninterrupted(tmp_path, evals, name):
    _, t_ev = evals
    straight = _t_params(_make(name).fit(t_ev.train_set, t_ev.val_set))
    _make(name, n_epochs=1).enable_checkpointing(tmp_path, every=1).fit(t_ev.train_set,
                                                                         t_ev.val_set)
    assert ck.CheckpointManager(tmp_path).all_steps() == [1]
    resumed = _t_params(_make(name).enable_checkpointing(tmp_path, every=1).fit(
        t_ev.train_set, t_ev.val_set))
    assert ck.CheckpointManager(tmp_path).all_steps() == [1, 2, 3]
    for key in straight:
        np.testing.assert_array_equal(resumed[key], straight[key], err_msg=key)


@pytest.mark.parametrize("name", ["FPMC", "GRU4Rec", "SASRec"])
def test_mesh_is_refused(name):
    # mesh= is ported (tests/test_torch_parallel_sequences.py): anything but
    # a parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tmodels, name)(mesh=object())


# one whole epoch on the JAX package's stream: the fits differ only by it
EPOCH_KW = {
    "GRU4Rec": dict(layers=[8], loss="bpr-max", batch_size=24, learning_rate=0.05, momentum=0.2,
                    n_epochs=1, n_sample=16, max_len=8, seed=5),
    "SASRec": dict(embedding_dim=8, num_blocks=2, loss="ce", batch_size=24, learning_rate=0.01,
                   n_epochs=1, n_sample=16, max_len=8, dropout=0.0, seed=5),
}


@pytest.mark.parametrize("name", sorted(EPOCH_KW))
def test_one_epoch_on_the_jax_stream_matches_the_jax_fit(evals, name):
    """The port's step, fed the JAX fit's own permutation and negatives
    (drawn here from its key as its program draws them), for a whole
    epoch, ends where the JAX package's 1-epoch fit ends."""
    j_ev, t_ev = evals
    kw = EPOCH_KW[name]
    jm = getattr(jmodels, name)(**kw).fit(j_ev.train_set)
    tm = getattr(tmodels, name)(**{**kw, "n_epochs": 0}).fit(t_ev.train_set)
    _, inputs, targets, mask = j_seq.build_session_examples(j_ev.train_set, kw["max_len"])
    rng = j_get_rng(kw["seed"])
    if name == "GRU4Rec":
        vocab = jm.total_items
        L = max(1, int(mask.sum(axis=1).max()))
        inputs, targets, mask = inputs[:, :L], targets[:, :L], mask[:, :L]
        j_gru._init_gru(rng, vocab, kw["layers"], 0, True)
        pad, opt = 0, adagrad_m(kw["learning_rate"], kw["momentum"])
    else:
        vocab = jm.num_items
        L = kw["max_len"]
        n_in = mask.sum(axis=1).astype(int)
        left = [np.full_like(inputs, vocab), np.zeros_like(targets), np.zeros_like(mask)]
        for b, ln in enumerate(n_in):
            for dst, src in zip(left, (inputs, targets, mask)):
                dst[b, L - ln:] = src[b, :ln]
        inputs, targets, mask = left
        j_sas._init_sasrec(rng, vocab, kw["embedding_dim"], kw["num_blocks"], L, True, False)
        pad, opt = vocab, adam(kw["learning_rate"], b1=0.9, b2=0.98)
    n = inputs.shape[0]
    bsz = j_seq.sessions_per_batch(kw["batch_size"], mask, n)
    extra = (-n) % bsz
    inputs = np.concatenate([inputs, np.full((extra, L), pad, inputs.dtype)])
    targets = np.concatenate([targets, np.zeros((extra, L), targets.dtype)])
    mask = np.concatenate([mask, np.zeros((extra, L), mask.dtype)])
    cum = j_seq.neg_sampling_table(j_ev.train_set, 0.5, vocab)
    ekey = jax.random.fold_in(jax.random.PRNGKey(rng.randint(2**31)), 0)
    order = np.asarray(jax.random.permutation(ekey, inputs.shape[0]))
    params = dict(tm.params.named_parameters())
    state = opt.init(params)
    for b in range(inputs.shape[0] // bsz):
        idx = order[b * bsz:(b + 1) * bsz]
        k_neg = jax.random.split(jax.random.fold_in(ekey, b))[1]
        negs = torch.from_numpy(np.asarray(j_seq.sample_negatives(k_neg, cum, (kw["n_sample"],))))
        seq, tgt = (torch.from_numpy(a[idx]).long() for a in (inputs, targets))
        m = torch.from_numpy(mask[idx])
        if name == "GRU4Rec":
            loss = tm.loss_on(seq, tgt, m, None, negs)
        else:
            states = t_sas._sasrec_states(tm.params, seq, vocab, 1)
            loss = t_seq.batch_loss(kw["loss"], states, tm.params.emb, None, tgt, m, negs)
        state = step(params, opt, state, loss)
    _assert_module(tm.params, _numpy_tree(jm.params), dict(rtol=1e-4, atol=1e-5))
