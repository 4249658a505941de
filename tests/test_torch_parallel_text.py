"""The ``mesh=`` branches of the port's text and review models (the rest of
ROADMAP A8 (d)) on a group of four gloo ranks on the CPU, against the
port's single-device fits and, for ConvMF and CTR, the JAX package's mesh
fits.

The module-scoped fixture ``ranks`` starts this file as four ranks
(``tests/gloo_ranks.py``). The ranks share out the single-device fits;
then every rank fits each case on the (data, model) layouts (4, 1), (2, 2)
and (1, 4), and rank 0 writes the results. The JAX side runs in the pytest
process on conftest's 8 virtual CPU devices. The cases mirror
``tests/test_parallel.py:754-824`` and ``:1052-1092`` (the JAX package's,
a slow file), on 300 users and 400 items with minibatches of 256 rows, so
that every rank holds rows of each minibatch (a slice is a multiple of 64
rows, ``parallel.sharded.SLICE_ROWS``):

- CTR: its ALS rows split over "data", the LDA step on the host; U, V,
  theta and beta the single-device fit's bits on every layout, and the
  2 x 2 mesh fit against the JAX package's mesh fit on a (2, 4) mesh at
  ``tests/test_torch_text.py``'s whole-fit tolerance;
- ConvMF and CVAE: the ALS rows split over "data" and the CNN's or the
  VAE's minibatches data-parallel over "data"; CDL and CDR data-parallel
  over every rank; NARRE and HRDR (its batch statistics summed over the
  ranks) data-parallel over every rank: the scores at the JAX tests'
  rtol 5e-4 / atol 5e-5, and ConvMF's 2 x 2 mesh fit against the JAX
  package's mesh fit as CTR's;
- NARRE and HRDR at their default minibatch of 64 rows and ConvMF at its
  default ``cnn_bs`` of 128 on the 4 x 1 layout, where ranks hold no rows
  of a minibatch: held as the cases above;
- every case and layout: every rank's fit equal to rank 0's bit for bit,
  the replicas of one model.
"""

import functools
import os
import sys

import numpy as np
import pytest

from gloo_ranks import LAYOUTS, gather_shares, join_group, spawn_ranks, write_results

SCORES = dict(rtol=5e-4, atol=5e-5)  # tests/test_parallel.py:754-824, :1052-1092
FIT = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_text.py's whole fits
N_USERS, N_ITEMS = 300, 400
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
REVIEW = dict(embedding_size=8, id_embedding_size=4, n_factors=4, attention_size=4,
              kernel_sizes=[2], n_filters=4, max_text_length=8, max_num_review=4,
              batch_size=256, max_iter=2, seed=7, verbose=False)

CONVMF = dict(k=4, n_epochs=2, cnn_epochs=1, cnn_bs=256, emb_dim=8, max_len=10,
              filter_sizes=(2,), num_filters=4, hidden_dim=8, seed=7, verbose=False)

# name: (model, constructor arguments, data, held, layouts); a tuple of
# attributes is held bit for bit, a dict of tolerances compares
# score_batch(0..7)
CASES = {
    "CTR": ("CTR", dict(k=4, max_iter=2, seed=7, verbose=False), "text",
            ("U", "V", "theta", "beta"), LAYOUTS),
    "ConvMF": ("ConvMF", CONVMF, "text", SCORES, LAYOUTS),
    "CVAE": ("CVAE", dict(z_dim=4, vae_layers=(8,), n_epochs=2, batch_size=256, seed=7,
                          verbose=False), "text", SCORES, LAYOUTS),
    "CDL": ("CDL", dict(k=4, autoencoder_structure=[8], max_iter=2, batch_size=256, seed=11,
                        verbose=False), "text", SCORES, LAYOUTS),
    "CDR": ("CDR", dict(k=4, autoencoder_structure=[8], max_iter=2, batch_size=256, seed=7,
                        verbose=False), "text", SCORES, LAYOUTS),
    "NARRE": ("NARRE", REVIEW, "reviews", SCORES, LAYOUTS),
    "HRDR": ("HRDR", dict(REVIEW, n_user_mlp_factors=8, n_item_mlp_factors=8), "reviews",
             SCORES, LAYOUTS),
    # the defaults' minibatches on four data ranks: NARRE's and HRDR's 64
    # rows all on rank 0, ConvMF's CNN batch of 128 on ranks 0 and 1
    "NARRE-64": ("NARRE", dict(REVIEW, batch_size=64, max_iter=1), "reviews", SCORES,
                 ("4x1",)),
    "HRDR-64": ("HRDR", dict(REVIEW, n_user_mlp_factors=8, n_item_mlp_factors=8, batch_size=64,
                             max_iter=1), "reviews", SCORES, ("4x1",)),
    "ConvMF-128": ("ConvMF", dict(CONVMF, cnn_bs=128), "text", SCORES, ("4x1",)),
}
PAIRS = [(name, layout) for name, case in CASES.items() for layout in case[4]]
JAX_HELD = ("ConvMF", "CTR")


def _split(pkg, kind):
    """The train set of data ``kind`` built with ``pkg`` (the port's or the
    JAX package's ``data`` and ``eval_methods`` modules): 3,000 star
    ratings of 300 users on 400 items, with a seeded document an item
    ("text") or a seeded review a rating ("reviews")."""
    from importlib import import_module

    data_mod, eval_mod = pkg
    rng = np.random.RandomState(21)
    pairs = sorted({(rng.randint(N_USERS), rng.randint(N_ITEMS)) for _ in range(3000)})
    ratings = [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]
    tokenizer = import_module(data_mod.__name__ + ".text").BaseTokenizer()
    side = {}
    if kind == "text":
        docs = [" ".join(rng.choice(WORDS, size=6).tolist()) for _ in range(N_ITEMS)]
        side["item_text"] = data_mod.TextModality(
            corpus=docs, ids=[f"i{x}" for x in range(N_ITEMS)], tokenizer=tokenizer,
            max_vocab=20)
    else:
        reviews = [(u, i, " ".join(rng.choice(WORDS, size=5).tolist())) for u, i, _ in ratings]
        side["review_text"] = data_mod.ReviewModality(data=reviews, tokenizer=tokenizer,
                                                      max_vocab=20)
    return eval_mod.RatioSplit(data=ratings, test_size=0.2, rating_threshold=2.5, seed=123,
                               **side).train_set


def _result(model, held):
    if isinstance(held, tuple):
        return {a: np.asarray(getattr(model, a)) for a in held}
    scores = model.score_batch(np.arange(8))
    assert np.isfinite(scores).all()
    return scores


def _replica(model, result):
    """What every rank's copy of a mesh fit must hold alike: ``result``,
    the factor tables and the networks' parameters."""
    out = dict(result) if isinstance(result, dict) else {"scores": result}
    for attr in ("U", "V", "P", "Q"):
        if isinstance(getattr(model, attr, None), np.ndarray):
            out[attr] = getattr(model, attr)
    for tree in ("params", "vae", "cnn", "sdae"):
        for name, t in (getattr(model, tree, None) or {}).items():
            out[f"{tree}.{name}"] = t.detach().cpu().numpy()
    return out


def _fit_case(name, mesh, train):
    import cornac_tpu_torch.models as P

    cls, kw, _, held, _ = CASES[name]
    model = getattr(P, cls)(mesh=mesh, **kw).fit(train)
    result = _result(model, held)
    return result if mesh is None else (result, _replica(model, result))


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    join_group(rank, port)
    from cornac_tpu_torch import data as pdata, eval_methods as peval
    from cornac_tpu_torch.parallel import make_mesh

    trains = {kind: _split((pdata, peval), kind) for kind in ("text", "reviews")}
    names = list(CASES)
    plain = {("plain", n): _fit_case(n, None, trains[CASES[n][2]])
             for n in names[rank::dist.get_world_size()]}
    out = gather_shares(plain)
    replicas = {}
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        for name in names:
            if layout in CASES[name][4]:
                out["fit", name, layout], replicas[name, layout] = _fit_case(
                    name, mesh, trains[CASES[name][2]])
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

    cls, kw, kind, _, _ = CASES[name]
    return getattr(J, cls)(mesh=make_mesh(data_parallel=2), **kw).fit(
        _split((jdata, jeval), kind))


@pytest.mark.parametrize("name, layout", PAIRS)
def test_mesh_fit_equals_single_device(ranks, name, layout):
    want, got = ranks["plain", name], ranks["fit", name, layout]
    held = CASES[name][3]
    if isinstance(held, tuple):
        assert want and set(got) == set(want)
        for attr in want:
            np.testing.assert_array_equal(got[attr], want[attr], err_msg=f"{name} {attr}")
    else:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, err_msg=name, **held)


@pytest.mark.parametrize("name, layout", PAIRS)
def test_mesh_fit_replicas_agree(ranks, name, layout):
    first, *rest = (r[name, layout] for r in ranks["replicas"])
    for rank, theirs in enumerate(rest, 1):
        assert set(theirs) == set(first)
        for key, want in first.items():
            np.testing.assert_array_equal(theirs[key], want, err_msg=f"{name} rank {rank} {key}")


@pytest.mark.parametrize("name", JAX_HELD)
def test_mesh_fit_matches_jax_mesh_fit(ranks, name):
    theirs = _jax_mesh_fit(name)
    got = ranks["replicas"][0][name, "2x2"]
    for table in ("U", "V"):
        want = np.asarray(getattr(theirs, table))
        assert got[table].shape == want.shape
        np.testing.assert_allclose(got[table], want, err_msg=table, **FIT)
    assert np.abs(got["V"] - got["V"].mean()).max() > 1e-3  # the fit moved the factors


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
