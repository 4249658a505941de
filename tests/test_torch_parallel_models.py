"""The ``mesh=`` branches of the port's factor and neural families on a
group of four gloo ranks on the CPU, against the port's single-device fits
and, for the deterministic fits, the JAX package's mesh fits.

The module-scoped fixture ``ranks`` starts this file as a script four
times (``python tests/test_torch_parallel_models.py <rank> <port>
<outdir>``), one process a rank with one thread, joined by
``init_distributed`` at ``tcp://127.0.0.1`` (``tests/gloo_ranks.py``). The ranks share out the
single-device fits of the cases; then every rank fits each case on the (data, model) layouts
(4, 1), (2, 2) and (1, 4), and rank 0 writes the results. The JAX side runs
in the pytest process on conftest's 8 virtual CPU devices, each reference
once for the module. The cases mirror ``tests/test_parallel.py`` (the JAX
package's, a slow file):

- ``:452-498`` PMF, NMF, SBPR and VEBPR, ``:983-1008`` FM-sgd and
  ``:1093-1157`` HPF (both settings) and C2PF (three variants): the
  fit's row sums go through ``accumulate_rows`` in batch or edge order, so
  the mesh fit equals the single-device fit bit for bit on every layout;
- IBPR, OnlineIBPR and COE (``:904-982``): their gradients are gathered
  per row and summed through ``accumulate_rows`` in batch order as the
  single-device backward sums them, so they too are held bit for bit;
- WMF (``:605-631``): each rank solves its share of the degree buckets'
  chunks, the same solves as on one device, so it is held bit for bit;
- the autograd fits, whose dense gradients are summed over the ranks in
  another order: VAECF, its index-window stream, RecVAE, BiVAECF, CVAECF
  and GCMC at the JAX tests' rtol 5e-4 / atol 5e-5, and LightGCN (dense and
  edge adjacency), NGCF, GMF, MLP and NeuMF at rtol 2e-4 / atol 2e-5
  (``:500-631``, ``:1392-1428``), NeuMF also with ``reg`` > 0;
- every case and layout: every rank's fit (its scores, and its parameters
  where the model keeps them as a tree) equals rank 0's bit for bit, the
  replicas of one model;
- NMF, WMF, HPF and C2PF: the port's mesh fit against the JAX package's
  mesh fit on the same inputs, at the tolerances of the single-device
  parity tests (``test_nmf_fit_matches_jax``, ``test_wmf_fit_matches_jax``,
  ``test_hpf_whole_fit``, ``test_c2pf_whole_fit_matches_jax``);
- ``NormAdjacency(mesh=)``: one propagation forward and backward, dense
  and edge forms, against the plain adjacency; ``FM(method="als", mesh=)``
  fits as ``FM(method="als")``.

A data slice of a minibatch is a multiple of 64 rows
(``parallel.sharded.SLICE_ROWS``), so the minibatches here are larger than
the JAX tests' (which split 16 rows over 8 devices): 256 rows and more, so
that several ranks hold rows of each. IBPR and CVAECF keep their batch sizes
multiples of the mesh size, which the JAX package's rounding leaves as
they are.
"""

import functools
import os
import sys
import time

import numpy as np
import pytest

from gloo_ranks import LAYOUTS, WORLD, gather_shares, join_group, spawn_ranks, write_results

AUTOGRAD = dict(rtol=5e-4, atol=5e-5)  # tests/test_parallel.py's VAE and misc tolerance
NEURAL = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py:605-631's


# ---------------------------------------------------------------------- #
# inputs, the same on both sides
# ---------------------------------------------------------------------- #
def _stars(seed, n_users, n_items, n):
    rng = np.random.RandomState(seed)
    return [(f"u{rng.randint(n_users)}", f"i{rng.randint(n_items)}", float(rng.randint(1, 6)))
            for _ in range(n)]


def _ones(seed, n_users, n_items, n):
    rng = np.random.RandomState(seed)
    return [(f"u{rng.randint(n_users)}", f"i{rng.randint(n_items)}", 1.0) for _ in range(n)]


def _item_edges(seed, n_items, n):
    rng = np.random.RandomState(seed)
    return sorted({(f"i{rng.randint(n_items)}", f"i{rng.randint(n_items)}", 1.0)
                   for _ in range(n)})


def _user_edges(seed, n_users, n):
    rng = np.random.RandomState(seed)
    return sorted({(f"u{rng.randint(n_users)}", f"u{rng.randint(n_users)}", 1.0)
                   for _ in range(n)})


def _split(pkg, kind):
    """The train set of data ``kind`` built with ``pkg`` (the port's or the
    JAX package's ``data`` and ``eval_methods`` modules)."""
    data_mod, eval_mod = pkg
    if kind == "stars":  # tests/test_parallel.py:452-498, :605-631
        return eval_mod.RatioSplit(data=_stars(3, 30, 50, 500), test_size=0.2,
                                   rating_threshold=2.5, seed=123).train_set
    if kind == "social":  # SBPR: every user has a friend
        graph = data_mod.GraphModality(data=[(f"u{u}", f"u{(u + 1) % 30}", 1.0)
                                             for u in range(30)])
        return eval_mod.RatioSplit(data=_stars(3, 30, 50, 500), test_size=0.2,
                                   rating_threshold=2.5, seed=123, user_graph=graph).train_set
    if kind == "views":  # VEBPR
        return data_mod.PurchaseViewDataset.build(_stars(3, 30, 50, 500),
                                                  _ones(5, 30, 50, 300), seed=7)
    if kind == "fm":  # :983-1008
        return eval_mod.RatioSplit(data=_stars(41, 30, 50, 400), test_size=0.2,
                                   rating_threshold=2.5, seed=123).train_set
    if kind == "hpf":  # :1093-1122
        return eval_mod.RatioSplit(data=_stars(9, 30, 50, 500), test_size=0.2,
                                   rating_threshold=2.5, seed=123).train_set
    if kind == "c2pf":  # :1124-1157
        graph = data_mod.GraphModality(data=_item_edges(13, 50, 150))
        return eval_mod.RatioSplit(data=_stars(12, 30, 50, 500), test_size=0.2,
                                   rating_threshold=2.5, seed=123, item_graph=graph).train_set
    if kind == "vae":  # :500-583, with 400 users: batches of 200 rows
        return eval_mod.RatioSplit(data=_ones(4, 400, 40, 3000), test_size=0.2,
                                   rating_threshold=0.5, seed=123).train_set
    if kind == "wide":  # the neural and misc cases with batches of 256 rows
        return eval_mod.RatioSplit(data=_stars(31, 300, 40, 3000), test_size=0.2,
                                   rating_threshold=2.5, seed=123).train_set
    if kind == "cvae":  # CVAECF: a user graph over 300 users
        graph = data_mod.GraphModality(data=_user_edges(32, 300, 900))
        return eval_mod.RatioSplit(data=_stars(31, 300, 40, 3000), test_size=0.2,
                                   rating_threshold=2.5, seed=123, user_graph=graph).train_set
    raise ValueError(kind)


# name: (data, class, constructor arguments, held); "bits" compares the
# fitted arrays exactly, a dict of tolerances compares score_batch(0..7)
CASES = {
    "PMF": ("stars", "PMF", dict(k=4, max_iter=5, seed=11), "bits"),
    "NMF": ("stars", "NMF", dict(k=4, max_iter=5, seed=11), "bits"),
    "NMF-bias": ("stars", "NMF", dict(k=4, max_iter=5, seed=11, use_bias=True), "bits"),
    "SBPR": ("social", "SBPR", dict(k=4, max_iter=5, seed=11), "bits"),
    "VEBPR": ("views", "VEBPR", dict(k=4, max_iter=5, seed=11), "bits"),
    "FM-sgd": ("fm", "FM", dict(k2=4, max_iter=5, method="sgd", seed=7, verbose=False),
               "bits"),
    "FM-als": ("fm", "FM", dict(k2=4, max_iter=3, method="als", seed=7, verbose=False),
               "bits"),
    "HPF": ("hpf", "HPF", dict(k=4, max_iter=10, seed=11, hierarchical=True), "bits"),
    "PF": ("hpf", "HPF", dict(k=4, max_iter=10, seed=11, hierarchical=False), "bits"),
    "C2PF": ("c2pf", "C2PF", dict(k=4, max_iter=8, seed=11, variant="c2pf"), "bits"),
    "TC2PF": ("c2pf", "C2PF", dict(k=4, max_iter=8, seed=11, variant="tc2pf"), "bits"),
    "RC2PF": ("c2pf", "C2PF", dict(k=4, max_iter=8, seed=11, variant="rc2pf"), "bits"),
    "IBPR": ("wide", "IBPR", dict(k=4, max_iter=3, batch_size=256, seed=7), "bits"),
    "OnlineIBPR": ("wide", "OnlineIBPR", dict(k=4, max_iter=3, batch_size=256, seed=7), "bits"),
    "COE": ("wide", "COE", dict(k=4, max_iter=3, batch_size=256, seed=7), "bits"),
    "WMF": ("stars", "WMF", dict(k=6, max_iter=5, seed=11, verbose=False), "bits"),
    "VAECF": ("vae", "VAECF", dict(k=4, autoencoder_structure=[8], n_epochs=5, batch_size=200,
                                   seed=11), AUTOGRAD),
    "VAECF-window": ("vae", "VAECF", dict(k=4, autoencoder_structure=[8], n_epochs=3,
                                          batch_size=200, seed=11), AUTOGRAD),
    "RecVAE": ("vae", "RecVAE", dict(hidden_dim=8, latent_dim=4, n_epochs=3, batch_size=200,
                                     seed=11), AUTOGRAD),
    "BiVAECF": ("vae", "BiVAECF", dict(k=4, encoder_structure=[8], n_epochs=3, batch_size=200,
                                       seed=11), AUTOGRAD),
    "LightGCN": ("wide", "LightGCN", dict(emb_size=8, num_epochs=3, batch_size=256, seed=11),
                 NEURAL),
    "LightGCN-edges": ("wide", "LightGCN", dict(emb_size=8, num_epochs=3, batch_size=256,
                                                seed=11), NEURAL),
    "NGCF": ("wide", "NGCF", dict(emb_size=8, layer_sizes=[8, 8], num_epochs=3, batch_size=256,
                                  seed=11), NEURAL),
    # two epochs: from the third on, this fit moves 1.8e-4 when its learning
    # rate moves by 1e-7 of itself (one device), which the order of a sum
    # over the ranks moves as much
    "GMF": ("wide", "GMF", dict(num_factors=4, num_epochs=2, batch_size=512, lr=0.01, seed=11,
                                verbose=False), NEURAL),
    "MLP": ("wide", "MLP", dict(layers=(8, 4), num_epochs=2, batch_size=512, lr=0.01, seed=11,
                                verbose=False), NEURAL),
    "NeuMF": ("wide", "NeuMF", dict(num_factors=4, layers=(8, 4), num_epochs=2, batch_size=512,
                                    lr=0.01, seed=11, verbose=False), NEURAL),
    # the penalty reaches the embeddings, whose gradients are not summed over
    # the ranks (ncf.NCFBase.fit)
    "NeuMF-reg": ("wide", "NeuMF", dict(num_factors=4, layers=(8, 4), num_epochs=2,
                                        batch_size=512, lr=0.01, reg=1e-3, seed=11,
                                        verbose=False), NEURAL),
    "CVAECF": ("cvae", "CVAECF", dict(z_dim=4, h_dim=4, autoencoder_structure=[8], n_epochs=3,
                                      batch_size=256, seed=7), AUTOGRAD),
    "GCMC": ("wide", "GCMC", dict(gcn_agg_units=8, gcn_out_units=8, max_iter=5, seed=7),
             AUTOGRAD),
}
# the attributes a "bits" case compares, by class
ARRAYS = {
    "PMF": ("U", "V"),
    "NMF": ("u_factors", "i_factors", "u_biases", "i_biases"),
    "SBPR": ("u_factors", "i_factors", "i_biases"),
    "VEBPR": ("u_factors", "i_factors"),
    "FM": ("w0", "w", "V"),
    "HPF": ("Gs", "Gr", "Ls", "Lr", "Theta", "Beta"),
    "C2PF": ("Gs", "Gr", "Ls", "Lr", "L2s", "L2r", "L3s", "L3r", "Theta", "Beta", "Xi"),
    "IBPR": ("U", "V"),
    "OnlineIBPR": ("U", "V"),
    "COE": ("U", "V"),
    "WMF": ("U", "V"),
}
JAX_HELD = ("NMF", "NMF-bias", "WMF", "HPF", "PF", "C2PF", "TC2PF", "RC2PF")
# the constructors that refuse mesh= because the JAX package's take none
REFUSING = {"HFT": "cornac_tpu.models.HFT", "TriRank": "cornac_tpu.models.TriRank"}


def _result(model, held):
    if held == "bits":
        return {a: np.asarray(getattr(model, a)) for a in ARRAYS[type(model).__name__]}
    return model.score_batch(np.arange(8))


def _replica(model, result):
    """What every rank's copy of a mesh fit must hold alike: ``result``,
    and the parameters of a model that keeps them as a tree."""
    out = dict(result) if isinstance(result, dict) else {"scores": result}
    params = getattr(model, "params", None)
    if hasattr(params, "named_parameters"):
        out.update((n, p.detach().cpu().numpy()) for n, p in params.named_parameters())
    return out


def _fit_case(name, mesh, train):
    import cornac_tpu_torch.models as P
    from cornac_tpu_torch.models import vaecf as vaecf_mod
    from cornac_tpu_torch.ops import graph as graph_mod

    _, cls, kw, held = CASES[name]
    restore = []
    if name == "VAECF-window" and mesh is not None:
        restore.append((vaecf_mod, "_RESIDENT_BYTES", vaecf_mod._RESIDENT_BYTES))
        vaecf_mod._RESIDENT_BYTES = 0
    if name == "LightGCN-edges":
        orig = graph_mod.NormAdjacency.__init__
        restore.append((graph_mod.NormAdjacency, "__init__", orig))

        def edge_only(self, ts, budget_elems=0, mesh=None, device=None):
            orig(self, ts, budget_elems=0, mesh=mesh, device=device)

        graph_mod.NormAdjacency.__init__ = edge_only
    try:
        model = getattr(P, cls)(mesh=mesh, **kw).fit(train)
        if mesh is not None and name == "VAECF-window":
            assert model.data_mode == "streamed", model.data_mode
        result = _result(model, held)
        return result if mesh is None else (result, _replica(model, result))
    finally:
        for owner, attr, value in restore:
            setattr(owner, attr, value)


def _adjacency_case(mesh, train, dense):
    """One propagation forward and backward through ``NormAdjacency``:
    (messages to users, messages to items, the embeddings' gradients)."""
    import torch

    from cornac_tpu_torch.ops.graph import NormAdjacency

    rng = np.random.RandomState(17)
    ue = torch.tensor(rng.randn(train.num_users, 8).astype(np.float32), requires_grad=True)
    ie = torch.tensor(rng.randn(train.num_items, 8).astype(np.float32), requires_grad=True)
    adj = NormAdjacency(train, budget_elems=10**9 if dense else 0, mesh=mesh, device="cpu")
    assert (adj.dense is not None) == dense
    mu, mi = adj.lightgcn(ue, ie, 3)
    w_u = torch.tensor(rng.randn(*mu.shape).astype(np.float32))
    w_i = torch.tensor(rng.randn(*mi.shape).astype(np.float32))
    loss = (mu * w_u).sum() + (mi * w_i).sum()
    if mesh is None:
        gu, gi = torch.autograd.grad(loss, [ue, ie])
    else:  # every rank's loss is the whole one: each takes a share, the shares are summed
        from cornac_tpu_torch.parallel.sharded import all_sum

        gu, gi = (all_sum(mesh, g, None) for g in torch.autograd.grad(loss / WORLD, [ue, ie]))
    return mu.detach().numpy(), mi.detach().numpy(), gu.numpy(), gi.numpy()


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    join_group(rank, port)
    import cornac_tpu_torch.models as P
    from cornac_tpu_torch import data as pdata, eval_methods as peval
    from cornac_tpu_torch.parallel import make_mesh

    only = os.environ.get("PARALLEL_MODEL_CASES")
    names = [n for n in CASES if only is None or n in only.split(",")]
    out = {}
    replicas = {}
    trains = {}

    def train_of(kind):
        if kind not in trains:
            trains[kind] = _split((pdata, peval), kind)
        return trains[kind]

    # the single-device fits, one thread as each rank, shared out over the ranks
    plain = {("plain", name): _fit_case(name, None, train_of(CASES[name][0]))
             for name in names[rank::WORLD]}
    if rank == 0:
        for dense in (True, False):
            plain["adj", "plain", dense] = _adjacency_case(None, train_of("wide"), dense)
    out.update(gather_shares(plain))
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        for name in names:
            t0 = time.perf_counter()
            out["fit", name, layout], replicas[name, layout] = _fit_case(
                name, mesh, train_of(CASES[name][0]))
            print(f"{name} {layout} {time.perf_counter() - t0:.2f} s", flush=True)
        for dense in (True, False):
            out["adj", layout, dense] = _adjacency_case(mesh, train_of("wide"), dense)
    every = [None] * WORLD
    dist.all_gather_object(every, replicas)
    out["replicas"] = every
    if rank == 0:
        refusals = {}
        for cls, item in REFUSING.items():
            try:
                getattr(P, cls)(mesh=mesh)
                refusals[cls] = None
            except NotImplementedError as e:
                refusals[cls] = str(e)
        out["refusals"] = refusals
    write_results(outdir, out)


# ---------------------------------------------------------------------- #
# pytest side
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, tmp_path_factory.mktemp("ranks"))


@functools.lru_cache(maxsize=None)
def _jax_mesh_fit(name):
    """The JAX package's fit of case ``name`` on a (2, 4) mesh of conftest's
    8 devices."""
    import cornac_tpu.models as J
    from cornac_tpu import data as jdata, eval_methods as jeval
    from cornac_tpu.parallel import make_mesh

    kind, cls, kw, _ = CASES[name]
    model = getattr(J, cls)(mesh=make_mesh(data_parallel=2), **kw)
    return model.fit(_split((jdata, jeval), kind))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_fit_equals_single_device(ranks, name, layout):
    want, got = ranks["plain", name], ranks["fit", name, layout]
    held = CASES[name][3]
    if held == "bits":
        assert want and set(got) == set(want)
        for attr in want:
            np.testing.assert_array_equal(got[attr], want[attr], err_msg=f"{name} {attr}")
    else:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, err_msg=name, **held)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_fit_replicas_agree(ranks, name, layout):
    first, *rest = (r[name, layout] for r in ranks["replicas"])
    for rank, theirs in enumerate(rest, 1):
        assert set(theirs) == set(first)
        for key, want in first.items():
            np.testing.assert_array_equal(theirs[key], want, err_msg=f"{name} rank {rank} {key}")


@pytest.mark.parametrize("name", JAX_HELD)
def test_mesh_fit_matches_jax_mesh_fit(ranks, name):
    got = ranks["fit", name, "2x2"]
    theirs = _jax_mesh_fit(name)
    if name.startswith("NMF"):  # test_nmf_fit_matches_jax's FIT
        for attr, value in got.items():
            np.testing.assert_allclose(value, np.asarray(getattr(theirs, attr)), rtol=1e-4,
                                       atol=1e-5, err_msg=attr)
    elif name == "WMF":  # test_wmf_fit_matches_jax's bound
        for attr, value in got.items():
            want = np.asarray(getattr(theirs, attr))
            np.testing.assert_allclose(value, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                                       err_msg=attr)
    else:  # test_hpf_whole_fit's and test_c2pf_whole_fit_matches_jax's
        for attr in ("Theta", "Beta") + (("Xi",) if CASES[name][1] == "C2PF" else ()):
            np.testing.assert_allclose(got[attr], np.asarray(getattr(theirs, attr)), rtol=1e-3,
                                       atol=1e-6, err_msg=attr)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edges"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_norm_adjacency_mesh_propagates_as_plain(ranks, layout, dense):
    want, got = ranks["adj", "plain", dense], ranks["adj", layout, dense]
    for g, w, what in zip(got, want, ("to users", "to items", "user grad", "item grad")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


def test_later_items_still_refuse_mesh(ranks):
    # every other constructor takes mesh= since A8 closed; these two refuse a
    # make_mesh mesh, naming the JAX constructor that takes none
    for cls, jax_name in REFUSING.items():
        msg = ranks["refusals"][cls]
        assert msg is not None and jax_name in msg and "takes no mesh" in msg, (cls, msg)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
