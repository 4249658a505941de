"""The port's CVAECF and GCMC against the JAX package's, on the CPU.

- Initial parameters: bit for bit from the same ``get_rng`` seed.
- CVAECF: the loss on the JAX package's own noise (drawn in the test from
  the key the JAX loss splits) and its gradients within rtol 1e-5 / atol
  1e-6, then one Adam step; a converted fit (``convert.model_from_params``)
  scores users as the JAX model does.
- GCMC: the encoder (stack and sum across ratings) and the decoder on the
  same parameters within rtol 1e-5 / atol 1e-6; the training loss, its
  gradients and one clipped Adam step; a converted fit's expected ratings.
- Bits: seeded refits (GCMC with a validation set, through early stopping
  and the learning-rate decay), and CVAECF stopped and resumed from its
  checkpoints gives the uninterrupted fit.
- Refusals: ``mesh=`` other than a ``parallel.make_mesh`` mesh.
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
from cornac_tpu.engine.nn import ACTIVATIONS as J_ACT
from cornac_tpu.models import cvaecf as j_cvae, gcmc as j_gcmc
from cornac_tpu.utils import get_rng as j_get_rng

import cornac_tpu_torch
import cornac_tpu_torch.data as tdata
import cornac_tpu_torch.eval_methods as teval
import cornac_tpu_torch.models as tmodels
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.engine.nn import ACTIVATIONS
from cornac_tpu_torch.models import cvaecf as t_cvae, gcmc as t_gcmc
from cornac_tpu_torch.ops.optim import adam, step
from cornac_tpu_torch.utils import checkpoint as ck
from cornac_tpu_torch.utils import get_rng

from test_torch_nn import flatten

cornac_tpu_torch.set_default_device("cpu")

TOL = dict(rtol=1e-5, atol=1e-6)


def _ratings(seed=4, n_users=30, n_items=40, n=420):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]


def _trust(seed=5, n_users=30, n=90):
    rng = np.random.RandomState(seed)
    return [(f"u{a}", f"u{b}", 1.0) for a, b in rng.randint(n_users, size=(n, 2)) if a != b]


def _splits(graph=False, val=False):
    out = []
    for data, ev in ((jdata, jeval), (tdata, teval)):
        kw = dict(user_graph=data.GraphModality(data=_trust())) if graph else {}
        out.append(ev.RatioSplit(data=_ratings(), test_size=0.2, val_size=0.1 if val else 0.0,
                                 rating_threshold=3.0, exclude_unknowns=True, seed=123, **kw))
    return out


@pytest.fixture(scope="module")
def graph_splits():
    return _splits(graph=True)


def _assert_module(module, tree, exact=False, tol=TOL):
    want = flatten(tree)
    got = {n: p.detach().numpy() for n, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        if exact:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], **tol, err_msg=n)


def _grads(loss, module):
    params = dict(module.named_parameters())
    return dict(zip(params, (g.numpy() for g in torch.autograd.grad(
        loss, list(params.values()), materialize_grads=True))))


# ----------------------------------------------------------------- CVAECF --
@pytest.mark.parametrize("likelihood", ["mult", "bern", "gaus", "pois"])
def test_cvaecf_init_loss_grads_and_adam_step(likelihood, n_items=20, n_users=16, bsz=6):
    sizes_y, sizes_x = [n_items, 10], [n_users, 10]
    tree = j_cvae._init_cvae(j_get_rng(9), 4, 3, sizes_y, sizes_x)
    module = t_cvae._init_cvae(get_rng(9), 4, 3, sizes_y, sizes_x)
    _assert_module(module, tree, exact=True)

    rng = np.random.RandomState(0)
    y = (rng.rand(bsz, n_items) < 0.3).astype(np.float32)
    x = (rng.rand(bsz, n_users) < 0.2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kz, kh = jax.random.split(key)
    noise_z = np.asarray(jax.random.normal(kz, (bsz, 4)))
    noise_h = np.asarray(jax.random.normal(kh, (bsz, 3)))
    args = (J_ACT["tanh"], likelihood, 1.0, 0.7, 0.4)
    loss, j_grads = jax.value_and_grad(j_cvae._cvae_loss)(
        tree, jnp.asarray(y), jnp.asarray(x), key, *args)

    def ours():
        return t_cvae._cvae_loss(module, torch.from_numpy(y), torch.from_numpy(x),
                                 torch.from_numpy(noise_z), torch.from_numpy(noise_h),
                                 ACTIVATIONS["tanh"], likelihood, 1.0, 0.7, 0.4)

    t_loss = ours()
    np.testing.assert_allclose(float(t_loss), float(loss), **TOL)
    got, want = _grads(t_loss, module), flatten(j_grads)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
    opt = optax.adam(0.01)
    updates, _ = opt.update(j_grads, opt.init(tree), tree)
    params = dict(module.named_parameters())
    t_opt = adam(0.01)
    step(params, t_opt, t_opt.init(params), ours())
    _assert_module(module, optax.apply_updates(tree, updates))


CVAE_KW = dict(z_dim=4, h_dim=3, autoencoder_structure=[10], n_epochs=3, batch_size=8, seed=11)


def _meta(model, options):
    meta = {name: getattr(model, name) for name in options}
    meta.update(num_users=model.num_users, num_items=model.num_items, uid_map=model.uid_map,
                iid_map=model.iid_map, min_rating=model.min_rating,
                max_rating=model.max_rating, global_mean=model.global_mean)
    return meta


def test_cvaecf_converted_fit_scores_as_jax(graph_splits):
    j_rs, t_rs = graph_splits
    jm = jmodels.CVAECF(**CVAE_KW).fit(j_rs.train_set)
    tm = model_from_params(
        "CVAECF", jax.tree_util.tree_map(np.asarray, jm.params),
        _meta(jm, ("z_dim", "h_dim", "autoencoder_structure", "act_fn", "likelihood")),
        device="cpu", train_set=t_rs.train_set)
    users = np.arange(-1, t_rs.train_set.num_users + 1)
    np.testing.assert_allclose(tm.score_batch(users), jm.score_batch(users), **TOL)
    np.testing.assert_allclose(tm.score(2), jm.score(2), **TOL)
    with pytest.raises(ValueError, match="user_graph"):
        tmodels.CVAECF(**CVAE_KW).fit(_splits()[1].train_set)


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.params.state_dict().items()}


def test_cvaecf_refits_and_resume_give_the_same_bits(tmp_path, graph_splits):
    train = graph_splits[1].train_set
    straight = _state(tmodels.CVAECF(**CVAE_KW).fit(train))
    again = _state(tmodels.CVAECF(**{**CVAE_KW, "verbose": True}).fit(train))
    tmodels.CVAECF(**{**CVAE_KW, "n_epochs": 1}).enable_checkpointing(tmp_path, every=1).fit(train)
    assert ck.CheckpointManager(tmp_path).all_steps() == [1]
    resumed = _state(tmodels.CVAECF(**CVAE_KW).enable_checkpointing(tmp_path, every=1).fit(train))
    for key in straight:
        np.testing.assert_array_equal(again[key], straight[key], err_msg=key)
        np.testing.assert_array_equal(resumed[key], straight[key], err_msg=key)


# ------------------------------------------------------------------- GCMC --
def _graph_pair(train_j, train_t):
    jm, tm = jmodels.GCMC(), tmodels.GCMC(device="cpu")
    for m, train in ((jm, train_j), (tm, train_t)):
        m.num_users, m.num_items = train.num_users, train.num_items
    return jm._build_graph(train_j), tm._build_graph(train_t, "cpu"), jm.rating_values


@pytest.mark.parametrize("agg_accum", ["stack", "sum"])
def test_gcmc_encode_decode_loss_and_step_match(agg_accum, lr=0.01, clip=0.05):
    j_rs, t_rs = _splits()
    j_graph, t_graph, values = _graph_pair(j_rs.train_set, t_rs.train_set)
    R, U, I = len(values), j_rs.train_set.num_users, j_rs.train_set.num_items
    agg = 20 - 20 % R if agg_accum == "stack" else 20
    tree = j_gcmc._init_gcmc(j_get_rng(3), U, I, R, agg, 6, agg_accum, False, 2)
    module = t_gcmc._init_gcmc(get_rng(3), U, I, R, agg, 6, agg_accum, False, 2)
    _assert_module(module, tree, exact=True)

    act = "leaky_relu"
    ju, ji = j_gcmc._encode(tree, j_graph, J_ACT[act], R, agg_accum, 0.0, None)
    tu, ti = t_gcmc._encode(module, t_graph, ACTIVATIONS[act], R, agg_accum, 0.0, None)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **TOL)
    pu, pi = t_graph["edge_u"], t_graph["edge_i"]
    jl = j_gcmc._decode_pairs(tree, ju, ji, j_graph["edge_u"], j_graph["edge_i"])
    tl = t_gcmc._decode_pairs(module, tu, ti, pu, pi)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)

    lab = j_graph["edge_label"]

    def j_loss(p):
        u, i = j_gcmc._encode(p, j_graph, J_ACT[act], R, agg_accum, 0.0, None)
        logits = j_gcmc._decode_pairs(p, u, i, j_graph["edge_u"], j_graph["edge_i"])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, lab))

    loss, j_grads = jax.value_and_grad(j_loss)(tree)
    t_lab = t_graph["edge_label"]
    ce = torch.logsumexp(tl, dim=1) - tl.gather(1, t_lab[:, None])[:, 0]
    t_loss = torch.mean(ce)
    np.testing.assert_allclose(float(t_loss), float(loss), **TOL)
    got, want = _grads(t_loss, module), flatten(j_grads)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
    # one clipped Adam step at the optimizer's unit rate scaled by lr
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    updates, _ = opt.update(j_grads, opt.init(tree), tree)
    t_opt = adam(1.0)
    grads = t_gcmc._clip_by_global_norm({n: torch.from_numpy(g) for n, g in got.items()}, clip)
    t_updates, _ = t_opt.update(grads, t_opt.init(dict(module.named_parameters())))
    want = flatten(optax.apply_updates(tree, updates))
    for n, p in module.named_parameters():
        np.testing.assert_allclose((p + t_updates[n] * lr).detach().numpy(), want[n], **TOL,
                                   err_msg=n)


GCMC_KW = dict(max_iter=6, gcn_agg_units=20, gcn_out_units=6, learning_rate=0.02, seed=5)


def test_gcmc_converted_fit_rates_as_jax():
    j_rs, t_rs = _splits()
    jm = jmodels.GCMC(**GCMC_KW).fit(j_rs.train_set)
    tm = model_from_params("GCMC", jax.tree_util.tree_map(np.asarray, jm.params),
                           _meta(jm, ("activation_func", "gcn_agg_accum")), device="cpu",
                           train_set=t_rs.train_set)
    np.testing.assert_allclose(tm.ufeat.numpy(), jm.ufeat, **TOL)
    users = np.arange(-1, 5)
    np.testing.assert_allclose(tm.score_batch(users), jm.score_batch(users), **TOL)
    tu, ti, _ = t_rs.test_set.uir_tuple
    jm.transform(j_rs.test_set)
    tm.transform(t_rs.test_set)
    for u, i in zip(tu[:20], ti[:20]):
        np.testing.assert_allclose(tm.score(u, i), jm.score(u, i), **TOL)


def test_gcmc_refits_with_early_stopping_give_the_same_bits():
    _, t_rs = _splits(val=True)
    kw = dict(GCMC_KW, max_iter=12, train_early_stopping_patience=4, train_decay_patience=2,
              train_lr_decay_factor=0.5, train_min_learning_rate=0.005)
    a = tmodels.GCMC(**kw).fit(t_rs.train_set, t_rs.val_set)
    b = tmodels.GCMC(**{**kw, "verbose": True}).fit(t_rs.train_set, t_rs.val_set)
    for key, value in _state(a).items():
        np.testing.assert_array_equal(_state(b)[key], value, err_msg=key)
    np.testing.assert_array_equal(a.ufeat.numpy(), b.ufeat.numpy())


@pytest.mark.parametrize("name", ["CVAECF", "GCMC"])
def test_mesh_is_refused(name):
    # mesh= is ported (tests/test_torch_parallel_models.py): anything but a
    # parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(tmodels, name)(mesh=object())
