"""The ``mesh=`` branches of the port's side-information models (the first
half of ROADMAP A8 (d)) on a group of four gloo ranks on the CPU, against
the port's single-device fits and, for SoRec and MCF, the JAX package's
mesh fits.

The module-scoped fixture ``ranks`` starts this file as four ranks
(``tests/gloo_ranks.py``). The ranks share out the single-device fits;
then every rank fits each case on the (data, model) layouts (4, 1), (2, 2)
and (1, 4), and rank 0 writes the results. The JAX side runs in the pytest
process on conftest's 8 virtual CPU devices. The cases mirror
``tests/test_parallel.py:904-982``, ``:1009-1051`` and ``:1158-1190`` (the
JAX package's, a slow file), on 300 users and minibatches of 256 rows, so
that every rank holds rows of each (a data slice is a multiple of 64
rows, ``parallel.sharded.SLICE_ROWS``):

- SoRec (with and without its link weights) and MCF: U, V and Z
  row-sharded over "model", the RMSProp streams split over "data", the
  single-device fit's bits on every layout; and the 2 x 2 mesh fit against
  the JAX package's mesh fit on a (2, 4) mesh at
  ``tests/test_torch_stream.py::test_whole_fits_match_the_jax_fits``'
  tolerance;
- PCRL's PF sweep: its rating edges split over "data", the single-device
  sweep's bits on every layout (``pf_sweep(mesh=)`` on the same tables);
- the data-parallel autograd fits VBPR, AMR, CausalRec, VMF, DMRL (text,
  with dropout) and PCRL (its sweep and its item batches): the scores at
  the JAX tests' rtol 5e-4 / atol 5e-5;
- every case and layout: every rank's fit equal to rank 0's bit for bit,
  the replicas of one model.
"""

import functools
import os
import sys

import numpy as np
import pytest

from gloo_ranks import LAYOUTS, gather_shares, join_group, spawn_ranks, write_results

SIDE = dict(rtol=5e-4, atol=5e-5)  # tests/test_parallel.py:904-982, :1009-1051, :1158-1190
STREAM_FIT = dict(rtol=0, atol=1e-5)  # tests/test_torch_stream.py's FIT
N_USERS, N_ITEMS = 300, 40

# name: (data, class, constructor arguments, held); "bits" compares U, V
# and Z exactly, a dict of tolerances compares score_batch(0..7)
CASES = {
    "SoRec": ("social", "SoRec", dict(k=4, max_iter=3, batch_size=256, seed=7, verbose=False),
              "bits"),
    "SoRec-unweighted": ("social", "SoRec", dict(k=4, max_iter=3, batch_size=256, seed=7,
                                                 weight_link=False, verbose=False), "bits"),
    "MCF": ("network", "MCF", dict(k=4, max_iter=3, batch_size=256, seed=7, verbose=False),
            "bits"),
    "VBPR": ("image", "VBPR", dict(k=4, k2=4, n_epochs=3, batch_size=256, seed=11,
                                   verbose=False), SIDE),
    "AMR": ("image", "AMR", dict(k=4, k2=4, n_epochs=3, batch_size=256, seed=11,
                                 verbose=False), SIDE),
    "CausalRec": ("image", "CausalRec", dict(k=4, k2=4, n_epochs=3, batch_size=256, seed=7,
                                             verbose=False), SIDE),
    "VMF": ("image", "VMF", dict(k=4, d=4, n_epochs=3, batch_size=256, seed=7), SIDE),
    "DMRL": ("text", "DMRL", dict(embedding_dim=8, num_factors=2, num_neg=4, epochs=3,
                                  batch_size=256, dropout=0.1, seed=7), SIDE),
    # 400 items: the item batches of 256 rows reach every rank
    "PCRL": ("catalog", "PCRL", dict(k=4, z_dims=[8], max_iter=3, batch_size=256, seed=7),
             SIDE),
}
JAX_HELD = ("SoRec", "SoRec-unweighted", "MCF")


def _split(pkg, kind):
    """The train set of data ``kind`` built with ``pkg`` (the port's or the
    JAX package's ``data`` and ``eval_methods`` modules): 3,000 ratings of
    300 users on 40 items, with a user graph, an item graph, image
    features or item texts; "catalog": on 400 items, with an item graph."""
    data_mod, eval_mod = pkg
    rng = np.random.RandomState(31)
    n_items = 10 * N_ITEMS if kind == "catalog" else N_ITEMS
    pairs = sorted({(rng.randint(N_USERS), rng.randint(n_items)) for _ in range(3000)})
    ratings = [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]
    items = [f"i{x}" for x in range(N_ITEMS)]
    side = {}
    if kind == "social":
        side["user_graph"] = data_mod.GraphModality(data=sorted(
            {(f"u{rng.randint(N_USERS)}", f"u{rng.randint(N_USERS)}", 1.0) for _ in range(900)}))
    elif kind in ("network", "catalog"):
        side["item_graph"] = data_mod.GraphModality(data=sorted(
            {(f"i{rng.randint(n_items)}", f"i{rng.randint(n_items)}", 1.0)
             for _ in range(3 * n_items)}))
    elif kind == "image":
        side["item_image"] = data_mod.ImageModality(
            features=rng.normal(size=(N_ITEMS, 12)).astype(np.float32), ids=items)
    elif kind == "text":
        from importlib import import_module

        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
        docs = [" ".join(rng.choice(words, size=6).tolist()) for _ in range(N_ITEMS)]
        tokenizer = import_module(data_mod.__name__ + ".text").BaseTokenizer()
        side["item_text"] = data_mod.TextModality(corpus=docs, ids=items, tokenizer=tokenizer,
                                                  max_vocab=20)
    return eval_mod.RatioSplit(data=ratings, test_size=0.2, rating_threshold=2.5, seed=123,
                               **side).train_set


def _result(model, held):
    if held == "bits":
        return {a: np.asarray(getattr(model, a)) for a in ("U", "V", "Z")}
    scores = model.score_batch(np.arange(8))
    assert np.isfinite(scores).all()
    return scores


def _replica(model, result):
    """What every rank's copy of a mesh fit must hold alike: ``result``,
    and the parameters of a model that keeps them (DMRL, PCRL's nets)."""
    out = dict(result) if isinstance(result, dict) else {"scores": result}
    for name, t in (getattr(model, "params", None) or {}).items():
        out[name] = t.detach().cpu().numpy()
    return out


def _fit_case(name, mesh, train):
    import cornac_tpu_torch.models as P

    _, cls, kw, held = CASES[name]
    model = getattr(P, cls)(mesh=mesh, **kw).fit(train)
    result = _result(model, held)
    return result if mesh is None else (result, _replica(model, result))


def _sweep_inputs(train):
    """PCRL's PF sweep's inputs: seeded Gamma tables and the rating edges."""
    import torch

    rng = np.random.RandomState(4)
    n, d, k = train.num_users, train.num_items, 4
    tables = [torch.as_tensor(rng.gamma(50, scale=0.3 / 50, size=(rows, k)).astype(np.float32))
              for rows in (n, n, d, d)]
    rid, cid, val = train.uir_tuple
    edges = (torch.as_tensor(np.asarray(rid, np.int64)), torch.as_tensor(np.asarray(cid, np.int64)),
             torch.as_tensor(np.asarray(val, np.float32)))
    return tables, edges


def _sweep(mesh, train):
    from cornac_tpu_torch.models.pcrl import pf_sweep

    tables, edges = _sweep_inputs(train)
    return [t.numpy() for t in pf_sweep(*tables, *edges, mesh=mesh)]


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    join_group(rank, port)
    from cornac_tpu_torch import data as pdata, eval_methods as peval
    from cornac_tpu_torch.parallel import make_mesh

    trains = {kind: _split((pdata, peval), kind)
              for kind in ("social", "network", "catalog", "image", "text")}
    names = list(CASES)
    plain = {("plain", n): _fit_case(n, None, trains[CASES[n][0]])
             for n in names[rank::dist.get_world_size()]}
    if rank == 0:
        plain["sweep", "plain"] = _sweep(None, trains["network"])
    out = gather_shares(plain)
    replicas = {}
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        for name in names:
            out["fit", name, layout], replicas[name, layout] = _fit_case(
                name, mesh, trains[CASES[name][0]])
        out["sweep", layout] = _sweep(mesh, trains["network"])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, replicas)
    out["replicas"] = every
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


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pf_sweep_on_a_mesh_keeps_the_bits(ranks, layout):
    want, got = ranks["sweep", "plain"], ranks["sweep", layout]
    assert len(got) == len(want) == 4
    for what, g, w in zip(("G_s", "G_r", "Zik", "Tk"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", JAX_HELD)
def test_mesh_fit_matches_jax_mesh_fit(ranks, name):
    got = ranks["fit", name, "2x2"]
    theirs = _jax_mesh_fit(name)
    for table, ours in got.items():
        want = np.asarray(getattr(theirs, table))
        assert ours.shape == want.shape
        np.testing.assert_allclose(ours, want, err_msg=table, **STREAM_FIT)
    assert np.abs(got["U"]).max() > 1e-3  # the fit moved away from its N(0, 0.001) start


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
