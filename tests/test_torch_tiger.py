"""The port's TIGER against the JAX package's, on the CPU, at narrow widths
(latent 8, two levels of 8 codes, d_model 16, one encoder and one decoder
block; the sessions of ``test_torch_sequential`` with seeded 12-wide item
features; for the semantic IDs, some rows repeated so that codes collide).

- Bytes: ``_kmeans_np`` (n above and below k), ``_fit_rkmeans`` and
  ``_build_semantic_ids`` (the collision level, ``level_sizes``,
  ``prefix_children``, ``sid_to_item``); the RQ-VAE's initial encoder and
  decoder, its k-means codebooks from the same encoder outputs; the
  seq2seq's initial parameters (the zeroed pad row of the token table).
- rtol 1e-6 / atol 1e-7 of the peak (optax's own jitted and eager values
  differ by a rounding of the cosine, which 1 + cos enlarges near the end):
  ``warmup_cosine_decay_schedule`` at every step, the warmup's edge
  included, and its refusal when no step is left to decay; AdamW on it,
  five steps.
- rtol 1e-5 / atol 1e-6: ``_rq_quantize`` (the same codes), the encoder
  and the decoder forward; the RQ-VAE's and the seq2seq's loss, with
  gradients at rtol 1e-4 / atol 1e-5 (a token row's gradient sums many
  positions' terms that nearly cancel).
- rtol 1e-4 / atol 1e-5: the RQ-VAE's encoder, decoder and codebooks
  after two epochs (a code whose k-means items all fall in the first
  minibatch starts with a gradient of rounding alone: those rows, a
  minority, within Adam's step bound) and one seq2seq epoch under each
  schedule, on the JAX fit's own permutations, against the JAX package's
  fits; the semantic IDs equal.
- Within 1e-5: beam and exact scores of a JAX fit carried into the port
  (``model_from_params``), the beams' items the same.
- Bits: seeded fits in one run and in one-epoch chunks, a fit stopped and
  resumed from its checkpoints.
- Refusals: the constructors' errors, a ``mesh=`` that is no mesh; ``device="auto"`` means
  the card, or raise.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as jmodels
from cornac_tpu.models import tiger as j_tiger
from cornac_tpu.utils import get_rng as j_get_rng

import cornac_tpu_torch
import cornac_tpu_torch.data as tdata
import cornac_tpu_torch.eval_methods as teval
import cornac_tpu_torch.models as tmodels
from cornac_tpu_torch.convert import model_from_params, params_to_module
from cornac_tpu_torch.models import tiger as t_tiger
from cornac_tpu_torch.ops import optim
from cornac_tpu_torch.utils import checkpoint as ck
from cornac_tpu_torch.utils import get_rng

from test_torch_nn import flatten
from test_torch_sequential import ROWS, _evals, _histories, _split

cornac_tpu_torch.set_default_device("cpu")

TOL5 = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
NARROW = dict(rqvae_latent_dim=8, rqvae_hidden_dims=(16,), rqvae_num_levels=2,
              rqvae_codebook_size=8, rqvae_batch_size=16, d_model=16, d_ff=32, num_heads=2,
              d_kv=8, num_enc_layers=1, num_dec_layers=1, max_len=6, batch_size=16, n_beams=8,
              seed=123)


def _features(repeat=False):
    iids = sorted({t[2] for t in ROWS})
    feats = np.random.RandomState(5).rand(len(iids), 12).astype(np.float32)
    if repeat:  # repeated rows: the same codes, told apart by the last level
        feats[1::7] = feats[0]
    return feats, iids


@pytest.fixture(scope="module")
def evals():
    """Each package's split of the sessions, with its own FeatureModality
    of the same features."""
    feats, iids = _features()
    train, val, test = _split()
    return tuple(pkg.NextItemEvaluation.from_splits(
        train_data=train, test_data=test, val_data=val, fmt="USIT", exclude_unknowns=True,
        seed=123, mode="last", item_feature=data.FeatureModality(features=feats, ids=iids))
        for pkg, data in ((jeval, jdata), (teval, tdata)))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_module(module, tree, tol, what=""):
    for name, value in flatten(_numpy_tree(tree)).items():
        np.testing.assert_allclose(module.get_parameter(name).detach().numpy(), value, **tol,
                                   err_msg=f"{what} {name}")


def _jax_stream(seed, epoch, n_total, n, device):
    """The JAX package's epoch order: its key's permutation, modulo n."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return torch.from_numpy(np.asarray(jax.random.permutation(key, n_total)) % n)


# ------------------------------------------------------------- schedule --
@pytest.mark.parametrize("peak, warmup, total", [(1e-3, 10, 37), (3e-4, 0, 20), (0.01, 5, 6),
                                                 (1e-3, 1, 2), (5e-4, 7, 8)])
def test_warmup_cosine_schedule_matches_optax(peak, warmup, total):
    want = jax.jit(jax.vmap(optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)))
    counts = np.arange(0, total + 6, dtype=np.int32)
    got = optim.warmup_cosine_decay_schedule(0.0, peak, warmup, total)(torch.from_numpy(counts))
    assert got.dtype == torch.float32
    # near the end cos is about -1, so 1 + cos cancels and one rounding of
    # the cosine (which optax's own jitted and eager values differ by) is
    # about 1e-7 of the peak
    np.testing.assert_allclose(got.numpy(), np.asarray(want(jnp.asarray(counts))), rtol=1e-6,
                               atol=1e-7 * peak)
    assert float(got[0]) == (0.0 if warmup else np.float32(peak)) and float(got[-1]) == 0.0


@pytest.mark.parametrize("warmup, total", [(10, 10), (10, 4)])
def test_schedule_without_decay_steps_is_refused_as_by_optax(warmup, total):
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, min(warmup, total), total)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.warmup_cosine_decay_schedule(0.0, 1e-3, min(warmup, total), total)


def test_adamw_on_the_schedule_matches_optax():
    rng = np.random.RandomState(0)
    params = {"U": rng.randn(7, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    ref = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 5), weight_decay=0.01)
    ours = optim.adamw(optim.warmup_cosine_decay_schedule(0.0, 0.05, 2, 5), weight_decay=0.01)
    j_params = {n: jnp.asarray(p) for n, p in params.items()}
    t_params = {n: torch.tensor(p) for n, p in params.items()}
    j_state, t_state = ref.init(j_params), ours.init(t_params)
    for _ in range(5):
        g = {n: rng.randn(*p.shape).astype(np.float32) for n, p in params.items()}
        updates, j_state = ref.update({n: jnp.asarray(v) for n, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_updates, t_state = ours.update({n: torch.tensor(v) for n, v in g.items()}, t_state,
                                         t_params)
        optim.apply_updates(t_params, t_updates)
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------------------ tokenizers --
@pytest.mark.parametrize("n, k", [(150, 8), (5, 8)])
def test_kmeans_np_is_byte_identical(n, k):
    x = np.random.RandomState(2).randn(n, 6).astype(np.float32)
    j_rng, t_rng = j_get_rng(9), get_rng(9)
    want = j_tiger._kmeans_np(x, k, j_rng)
    got = t_tiger._kmeans_np(x, k, t_rng)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert j_rng.randint(2**31) == t_rng.randint(2**31)


def test_rkmeans_and_semantic_ids_are_byte_identical():
    feats, _ = _features(repeat=True)
    kw = dict(rqvae_num_levels=2, rqvae_codebook_size=4, seed=7)
    jm, tm = jmodels.TIGER(**kw), tmodels.TIGER(**kw)
    codes = tm._fit_rkmeans(feats)
    np.testing.assert_array_equal(codes, jm._fit_rkmeans(feats))
    for a, b in zip(tm.rkmeans_centroids, jm.rkmeans_centroids):
        np.testing.assert_array_equal(a, b)
    jm._build_semantic_ids(codes)
    tm._build_semantic_ids(codes)
    assert tm.level_sizes == jm.level_sizes and tm.level_sizes[-1] > 1  # a collision
    np.testing.assert_array_equal(tm.sid_table, jm.sid_table)
    assert tm.sid_to_item == jm.sid_to_item
    for t_level, j_level in zip(tm.prefix_children, jm.prefix_children):
        assert t_level.keys() == j_level.keys()
        for prefix in j_level:
            np.testing.assert_array_equal(t_level[prefix], j_level[prefix])


def test_rq_quantize_matches():
    rng = np.random.RandomState(3)
    cb = rng.randn(3, 8, 5).astype(np.float32)
    z = rng.randn(20, 5).astype(np.float32)

    def j_loss(cb, z):
        ids, q, loss = j_tiger._rq_quantize(cb, z, 0.25)
        return loss + 0.5 * jnp.sum(q ** 2), ids

    (j_val, j_ids), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cb), jnp.asarray(z))
    t_cb, t_z = (torch.tensor(a, requires_grad=True) for a in (cb, z))
    ids, q, loss = t_tiger._rq_quantize(t_cb, t_z, 0.25)
    t_val = loss + 0.5 * torch.sum(q ** 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL5)
    for g, want in zip(torch.autograd.grad(t_val, [t_cb, t_z]), j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL)


# ------------------------------------------------------------------ init --
@pytest.fixture(scope="module")
def jax_inits(evals):
    """The JAX package's fits of 0 epochs: the initial RQ-VAE (k-means
    codebooks) and seq2seq."""
    j_ev, _ = evals
    kw = dict(NARROW, rqvae_n_epochs=0, n_epochs=0)
    return {tok: jmodels.TIGER(**kw, tokenizer=tok).fit(j_ev.train_set)
            for tok in ("rqvae", "rkmeans")}


def test_rqvae_initial_parameters_and_codebooks_are_bit_identical(evals, jax_inits):
    j_ev, t_ev = evals
    jm = jax_inits["rqvae"]
    feats = np.asarray(j_ev.train_set.item_feature.features[:jm.total_items], np.float32)
    tm = tmodels.TIGER(**NARROW)
    init = tm._init_rqvae(feats.shape[1])
    for name in ("enc.0.w", "enc.0.b", "enc.1.w", "dec.0.w", "dec.1.w", "dec.1.b"):
        np.testing.assert_array_equal(init.get_parameter(name).detach().numpy(),
                                      flatten(_numpy_tree(jm.rqvae_params))[name], err_msg=name)
    # k-means on the same encoder outputs gives the same codebooks
    z = np.asarray(j_tiger._mlp_apply(jm.rqvae_params["enc"], jnp.asarray(feats)))
    np.testing.assert_array_equal(tm._kmeans_codebooks(z), np.asarray(jm.rqvae_params["codebooks"]))


def test_seq2seq_initial_parameters_are_bit_identical(evals, jax_inits):
    _, t_ev = evals
    jm = jax_inits["rkmeans"]
    tm = tmodels.TIGER(**NARROW, tokenizer="rkmeans", n_epochs=0).fit(t_ev.train_set)
    for attr in ("sid_table", "offsets", "enc_token_table"):
        np.testing.assert_array_equal(getattr(tm, attr), getattr(jm, attr), err_msg=attr)
    assert tm.level_sizes == jm.level_sizes
    names = flatten(_numpy_tree(jm.params))
    assert set(names) == {n for n, _ in tm.params.named_parameters()}
    for name, value in names.items():
        np.testing.assert_array_equal(tm.params.get_parameter(name).detach().numpy(), value,
                                      err_msg=name)
    assert not tm.params.tok_emb[0].any()


# --------------------------------------------------------------- forward --
def _tokens(jm, B=5, seed=4):
    """Encoder tokens of left-padded histories and target IDs."""
    rng = np.random.RandomState(seed)
    hists = np.full((B, jm.max_len), jm.pad_idx, np.int64)
    for b, n in enumerate([jm.max_len, 3, 1, 5, 2][:B]):
        hists[b, jm.max_len - n:] = rng.randint(jm.total_items, size=n)
    enc = jm.enc_token_table[hists].reshape(B, -1)
    return enc, jm.sid_table[rng.randint(jm.total_items, size=B)]


def test_encoder_decoder_and_seq2seq_loss_match(jax_inits):
    jm = jax_inits["rkmeans"]
    module = params_to_module(_numpy_tree(jm.params), "cpu")
    enc, tgt = _tokens(jm)
    j_out, j_mask = j_tiger._encoder(jm.params, jnp.asarray(enc), jm.num_heads)
    t_out, t_mask = t_tiger._encoder(module, torch.from_numpy(enc), jm.num_heads)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL5)
    offsets = torch.from_numpy(jm.offsets)
    j_h = j_tiger._decoder(jm.params, jm._dec_emb(jm.params, jnp.asarray(tgt[:, :-1])), j_out,
                           j_mask, jm.num_heads)
    t_h = t_tiger._decoder(module, t_tiger._dec_emb(module, offsets, torch.from_numpy(tgt[:, :-1])),
                           t_out, t_mask, jm.num_heads)
    np.testing.assert_allclose(t_h.detach().numpy(), np.asarray(j_h), **TOL5)

    j_val, j_grads = jax.jit(jax.value_and_grad(jm._seq2seq_loss))(jm.params, jnp.asarray(enc),
                                                                   jnp.asarray(tgt))
    t_val = t_tiger._seq2seq_loss(module, offsets, torch.from_numpy(enc), torch.from_numpy(tgt),
                                  jm.num_heads)
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL5)
    named = dict(module.named_parameters())
    want = flatten(_numpy_tree(j_grads))
    for (name, _), g in zip(named.items(), torch.autograd.grad(t_val, list(named.values()))):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL, err_msg=name)


def test_rqvae_loss_and_gradients_match(evals, jax_inits):
    j_ev, _ = evals
    jm = jax_inits["rqvae"]
    module = params_to_module(_numpy_tree(jm.rqvae_params), "cpu")
    x = np.asarray(j_ev.train_set.item_feature.features[:16], np.float32)
    (j_val, j_ids), j_grads = jax.value_and_grad(j_tiger._rqvae_loss, has_aux=True)(
        jm.rqvae_params, jnp.asarray(x), 0.25)
    t_val, t_ids = t_tiger._rqvae_loss(module, torch.from_numpy(x), 0.25)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(float(t_val), float(j_val), **TOL5)
    named = dict(module.named_parameters())
    want = flatten(_numpy_tree(j_grads))
    for (name, _), g in zip(named.items(), torch.autograd.grad(t_val, list(named.values()))):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL, err_msg=name)


# ------------------------------------------------------------ the epochs --
def test_rqvae_epochs_on_the_jax_stream_match_the_jax_fit(evals, monkeypatch):
    """Two RQ-VAE epochs (with the dead-code restart after each) on the JAX
    fit's permutations: the same encoder, decoder, codebooks and semantic
    IDs as the JAX package's fit. One kind of code is exempt: a k-means
    centroid whose items all fall in the first minibatch has a first
    gradient of rounding alone (the sum of its items' offsets from it),
    which Adam makes into steps of up to the learning rate, either way in
    either package. Those rows (a minority) are held to the steps times the
    learning rate, every other row to FIT_TOL."""
    j_ev, t_ev = evals
    kw = dict(NARROW, rqvae_n_epochs=2, n_epochs=0)
    jm = jmodels.TIGER(**kw).fit(j_ev.train_set)
    assigned, orders = [], []
    kmeans = t_tiger._kmeans_np

    def recording_kmeans(x, k, rng, n_iters=10):
        c = kmeans(x, k, rng, n_iters)
        assigned.append(t_tiger._nearest(x, c))
        return c

    def recording_stream(*args):
        orders.append(_jax_stream(*args))
        return orders[-1]

    monkeypatch.setattr(t_tiger, "_kmeans_np", recording_kmeans)
    monkeypatch.setattr(t_tiger, "_epoch_perm", recording_stream)
    tm = tmodels.TIGER(**kw).fit(t_ev.train_set)
    want = _numpy_tree(jm.rqvae_params)
    codebooks = want.pop("codebooks")
    _assert_module(tm.rqvae_params, want, FIT_TOL, "RQ-VAE")
    first = orders[0][:kw["rqvae_batch_size"]].numpy()
    exempt = np.array([[np.isin(np.flatnonzero(a == c), first).all() for c in range(len(cb))]
                       for a, cb in zip(assigned, codebooks)])
    assert len(assigned) == kw["rqvae_num_levels"] and 2 * exempt.sum() < exempt.size
    got = tm.rqvae_params.codebooks.detach().numpy()
    np.testing.assert_allclose(got[~exempt], codebooks[~exempt], **FIT_TOL)
    steps = 2 * -(-jm.total_items // kw["rqvae_batch_size"])
    np.testing.assert_allclose(got[exempt], codebooks[exempt], rtol=0,
                               atol=steps * tm.rqvae_learning_rate)
    np.testing.assert_array_equal(tm.sid_table, jm.sid_table)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_seq2seq_epochs_on_the_jax_stream_match_the_jax_fit(evals, monkeypatch, schedule):
    j_ev, t_ev = evals
    kw = dict(NARROW, tokenizer="rkmeans", n_epochs=2 if schedule == "cosine" else 1,
              lr_schedule=schedule, warmup_steps=3, learning_rate=0.01)
    jm = jmodels.TIGER(**kw).fit(j_ev.train_set)
    monkeypatch.setattr(t_tiger, "_epoch_perm", _jax_stream)
    tm = tmodels.TIGER(**kw).fit(t_ev.train_set)
    _assert_module(tm.params, jm.params, FIT_TOL, schedule)


# ---------------------------------------------------------------- scoring --
META = ("tokenizer", "rqvae_num_levels", "rqvae_codebook_size", "d_model", "d_ff", "num_heads",
        "d_kv", "num_enc_layers", "num_dec_layers", "max_len", "scoring", "n_beams")


def _converted(jm):
    meta = {k: getattr(jm, k) for k in META}
    meta.update({k: getattr(jm, k) for k in ("sid_table", "offsets", "enc_token_table",
                                             "level_sizes", "prefix_children", "sid_to_item")})
    meta["rqvae_params"] = (_numpy_tree(jm.rqvae_params) if jm.tokenizer == "rqvae" else None)
    meta.update(num_users=jm.num_users, num_items=jm.num_items, uid_map=jm.uid_map,
                iid_map=jm.iid_map, min_rating=jm.min_rating, max_rating=jm.max_rating,
                global_mean=jm.global_mean)
    return model_from_params("TIGER", _numpy_tree(jm.params), meta, device="cpu")


@pytest.mark.parametrize("tokenizer, scoring", [("rqvae", "beam"), ("rkmeans", "exact")])
def test_converted_fits_score_as_jax(evals, tokenizer, scoring):
    j_ev, t_ev = evals
    jm = jmodels.TIGER(**NARROW, tokenizer=tokenizer, scoring=scoring, rqvae_n_epochs=2,
                       n_epochs=1).fit(j_ev.train_set)
    tm = _converted(jm)
    users, hist = _histories(t_ev)
    hist = hist[:20] + [[]]  # an empty history scores ones
    got = tm.score_history_batch(users[:21], hist)
    want = jm.score_history_batch(users[:21], hist)
    assert got.shape == want.shape == (21, jm.total_items)
    np.testing.assert_array_equal(got == -1e10, want == -1e10)  # the same beams' items
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[-1], 1.0)
    np.testing.assert_allclose(tm.score(None, hist[0]), jm.score(None, hist[0]), rtol=1e-5,
                               atol=1e-5)
    if tokenizer == "rqvae":
        _assert_module(tm.rqvae_params, jm.rqvae_params, dict(rtol=0, atol=0))


# ------------------------------------------------------------------- bits --
def _t_params(model):
    return {k: v.detach().numpy().copy() for k, v in model.params.state_dict().items()}


def test_seeded_fits_in_one_run_and_in_chunks_are_identical(evals, capsys):
    _, t_ev = evals
    kw = dict(NARROW, rqvae_n_epochs=2, n_epochs=2, lr_schedule="cosine", warmup_steps=4)
    a = tmodels.TIGER(**kw).fit(t_ev.train_set)
    b = tmodels.TIGER(**kw, verbose=True).fit(t_ev.train_set)
    assert "TIGER epoch 2/2" in capsys.readouterr().out
    np.testing.assert_array_equal(a.sid_table, b.sid_table)
    pa, pb = _t_params(a), _t_params(b)
    for key in pa:
        np.testing.assert_array_equal(pa[key], pb[key], err_msg=key)


def test_resumed_fit_equals_uninterrupted(tmp_path, evals):
    _, t_ev = evals
    kw = dict(NARROW, tokenizer="rkmeans", n_epochs=3, model_selection="best", val_eval_every=1)
    straight = _t_params(tmodels.TIGER(**kw).fit(t_ev.train_set, t_ev.val_set))
    tmodels.TIGER(**{**kw, "n_epochs": 1}).enable_checkpointing(tmp_path, every=1).fit(
        t_ev.train_set, t_ev.val_set)
    resumed = _t_params(tmodels.TIGER(**kw).enable_checkpointing(tmp_path, every=1).fit(
        t_ev.train_set, t_ev.val_set))
    assert ck.CheckpointManager(tmp_path).all_steps() == [1, 2, 3]
    for key in straight:
        np.testing.assert_array_equal(resumed[key], straight[key], err_msg=key)


# --------------------------------------------------------------- refusals --
def test_constructor_errors_match_the_jax_package():
    for pkg in (jmodels, tmodels):
        for bad in (dict(scoring="nope"), dict(tokenizer="pq"), dict(lr_schedule="linear"),
                    dict(model_selection="every")):
            with pytest.raises(ValueError):
                pkg.TIGER(**bad)
        assert pkg.TIGER(**pkg.GRID_CONFIG).tokenizer == "rkmeans"
        assert pkg.TIGER(**pkg.PAISCHER_TOYS_CONFIG).d_model == 196


def test_features_are_required(evals):
    _, t_ev = evals
    no_features = _evals()[1]
    with pytest.raises(ValueError, match="item content embeddings"):
        tmodels.TIGER(**NARROW).fit(no_features.train_set)


def test_mesh_is_refused():
    # mesh= is ported (tests/test_torch_parallel_sequences.py): anything but
    # a parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmodels.TIGER(mesh=object())


def test_auto_device_is_the_card(monkeypatch):
    """``device="auto"`` (the JAX package's default) is the port's rule:
    the card, or raise; never the CPU by itself."""
    monkeypatch.setattr(cornac_tpu_torch.device, "_default", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodels.TIGER(device=device)._device()
    assert tmodels.TIGER(device="cpu")._device() == torch.device("cpu")
