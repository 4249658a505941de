"""The ``mesh=`` branches of the port's sentiment and explainable models
(the rest of ROADMAP A8 (d)) on a group of four gloo ranks on the CPU,
against the port's single-device fits and, for EFM and ComparERObj, the JAX
package's mesh fits.

The module-scoped fixture ``ranks`` starts this file as four ranks
(``tests/gloo_ranks.py``). The ranks share out the single-device fits;
then every rank fits each case on the (data, model) layouts (4, 1), (2, 2)
and (1, 4), and rank 0 writes the results. The JAX side runs in the pytest
process on conftest's 8 virtual CPU devices. The cases mirror
``tests/test_parallel.py:825-903`` (the JAX package's, a slow file; HypAR
has no JAX mesh test and is held as the others are), on 300 users with
streams and minibatches of at least 256 rows, so that every rank holds
samples of each (a slice is a multiple of 64 rows,
``parallel.sharded.SLICE_ROWS``):

- EFM and ComparERObj: the observation streams (and the comparative pairs)
  split over every rank, the tables replicated: the single-device fit's
  bits on every layout, and the 2 x 2 mesh fit against the JAX package's
  mesh fit on a (2, 4) mesh at ``tests/test_torch_sentiment.py``'s fit
  tolerance;
- MTER, ComparERSub, LRPPM and Companion: the sampled streams split over
  every rank, the sample counts rounded as the JAX package rounds them:
  the single-device fit's bits on every layout; a count that is no
  multiple of the ranks draws the JAX package's rounded count;
- HypAR: the whole-graph forward on every rank, the loss's rows split over
  every rank: the scores at the JAX tests' rtol 5e-4 / atol 5e-5, on the
  ranking objective (negatives) with the dot predictor and on the rating
  objective with the NARRE predictor, explainability and dropout. The NARRE
  predictor's shared bias and its user rows cancel in the ranking loss's
  differences: their exact gradient is 0, so AdamW walks them on rounding
  (up to a step of the learning rate each) in either layout, and the
  scores would differ by that walk, not by the mesh;
- every case and layout: every rank's fit equal to rank 0's bit for bit,
  the replicas of one model.
"""

import functools
import os
import sys

import numpy as np
import pytest

from gloo_ranks import LAYOUTS, WORLD, gather_shares, join_group, spawn_ranks, write_results

SCORES = dict(rtol=5e-4, atol=5e-5)  # tests/test_parallel.py:825-903
FIT = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_sentiment.py's FIT
N_USERS, N_ITEMS = 300, 40
ASPECTS = ["battery", "screen", "price", "camera"]
OPINIONS = ["good", "bad", "great"]
EFM_TABLES = ("U1", "U2", "V", "H1", "H2")
TUCKER_TABLES = ("G1", "G2", "G3", "U", "I", "A", "O")
SMALL = dict(n_user_factors=4, n_item_factors=4, n_aspect_factors=4, n_opinion_factors=4,
             n_bpr_samples=256, n_element_samples=256, max_iter=20, seed=7, verbose=False)
HYPAR = dict(node_dim=8, num_heads=2, num_epochs=2, batch_size=256, num_neg_samples=4,
             learning_rate=0.01, model_selection="last", seed=7, verbose=False)

# name: (class, constructor arguments, held); a tuple of attributes is held
# bit for bit, a dict of tolerances compares score_batch(0..7)
CASES = {
    "EFM": ("EFM", dict(num_explicit_factors=4, num_latent_factors=4, num_most_cared_aspects=3,
                        max_iter=10, seed=7, verbose=False), EFM_TABLES),
    "ComparERObj": ("ComparERObj", dict(num_explicit_factors=4, num_latent_factors=4,
                                        num_most_cared_aspects=3, max_iter=10, min_user_freq=2,
                                        seed=7, verbose=False), EFM_TABLES),
    "MTER": ("MTER", dict(SMALL), TUCKER_TABLES),
    "ComparERSub": ("ComparERSub", dict(SMALL, n_pair_samples=256, min_user_freq=2),
                    TUCKER_TABLES),
    "LRPPM": ("LRPPM", dict(n_factors=4, n_samples=256, n_ranking_samples=256, max_iter=20,
                            seed=7, verbose=False), ("U", "I", "UA", "IA")),
    "Companion": ("Companion", dict(SMALL, n_aspect_ranking_samples=256,
                                    n_opinion_ranking_samples=256, min_user_freq=2),
                  TUCKER_TABLES),
    "HypAR": ("HypAR", dict(HYPAR, predictor="dot"), SCORES),
    "HypAR-explain": ("HypAR", dict(HYPAR, objective="rating", learn_explainability=True,
                                    learn_method="transr", layer_dropout=0.1, combiner="self"),
                      SCORES),
}
JAX_HELD = ("EFM", "ComparERObj")
# MTER's counts, no multiple of the ranks: JAX's rounding gives (256, 256)
ODD_COUNTS = dict(n_element_samples=258, n_bpr_samples=259)


def _split(pkg):
    """The train set built with ``pkg`` (the port's or the JAX package's
    ``data`` and ``eval_methods`` modules): 3,000 timestamped star ratings
    of 300 users on 40 items, each with one to three seeded (aspect,
    opinion, polarity) tuples."""
    data_mod, eval_mod = pkg
    rng = np.random.RandomState(23)
    data, lexicon = [], []
    for t in range(3000):
        u, i = f"u{rng.randint(N_USERS)}", f"i{rng.randint(N_ITEMS)}"
        data.append((u, i, float(rng.randint(1, 6)), float(t)))
        lexicon.append((u, i, [(ASPECTS[rng.randint(len(ASPECTS))],
                                OPINIONS[rng.randint(len(OPINIONS))],
                                float(rng.choice([-1, 1])))
                               for _ in range(rng.randint(1, 4))]))
    return eval_mod.RatioSplit(data=data, fmt="UIRT", test_size=0.2, rating_threshold=2.5,
                               seed=123, sentiment=data_mod.SentimentModality(data=lexicon)
                               ).train_set


def _result(model, held):
    if isinstance(held, tuple):
        return {a: np.asarray(getattr(model, a)) for a in held}
    scores = model.score_batch(np.arange(8))
    assert np.isfinite(scores).all()
    return scores


def _replica(model, result):
    """What every rank's copy of a mesh fit must hold alike: ``result``,
    and HypAR's parameters."""
    out = dict(result) if isinstance(result, dict) else {"scores": result}
    if CASES.get(model.name, ("",))[0] == "HypAR":
        out.update((f"params.{n}", a) for n, a in model.params.items())
    return out


def _fit_case(name, mesh, train, **extra):
    import cornac_tpu_torch.models as P
    from cornac_tpu_torch.models.hypar import fixed_svds_start

    cls, kw, held = CASES[name]
    with fixed_svds_start(0):
        model = getattr(P, cls)(mesh=mesh, name=name, **{**kw, **extra}).fit(train)
    result = _result(model, held)
    return result if mesh is None else (result, _replica(model, result))


def _odd_counts(mesh, train):
    """The sample counts a mesh fit of MTER with ``ODD_COUNTS`` draws:
    (element samples, BPR samples) of its first draw."""
    from cornac_tpu_torch.models import mter as mter_mod

    seen, draws = [], mter_mod.mter_draws

    def recording(generator, n_iters, data, n_el, n_bpr, *rest):
        seen.append((n_el, n_bpr))
        return draws(generator, n_iters, data, n_el, n_bpr, *rest)

    mter_mod.mter_draws = recording
    try:
        _fit_case("MTER", mesh, train, **ODD_COUNTS)
    finally:
        mter_mod.mter_draws = draws
    return seen[0]


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    join_group(rank, port)
    from cornac_tpu_torch import data as pdata, eval_methods as peval
    from cornac_tpu_torch.parallel import make_mesh

    train = _split((pdata, peval))
    names = list(CASES)
    plain = {("plain", n): _fit_case(n, None, train)
             for n in names[rank::dist.get_world_size()]}
    out = gather_shares(plain)
    replicas = {}
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        for name in names:
            out["fit", name, layout], replicas[name, layout] = _fit_case(name, mesh, train)
        if layout == "2x2":
            out["odd counts"] = _odd_counts(mesh, train)
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

    cls, kw, _ = CASES[name]
    return getattr(J, cls)(mesh=make_mesh(data_parallel=2), **kw).fit(_split((jdata, jeval)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_fit_equals_single_device(ranks, name, layout):
    want, got = ranks["plain", name], ranks["fit", name, layout]
    held = CASES[name][2]
    if isinstance(held, tuple):
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
    theirs = _jax_mesh_fit(name)
    got = ranks["fit", name, "2x2"]
    for table, ours in got.items():
        want = np.asarray(getattr(theirs, table))
        assert ours.shape == want.shape
        np.testing.assert_allclose(ours, want, err_msg=table, **FIT)


def test_mter_mesh_fit_draws_the_jax_rounded_counts(ranks):
    # the JAX package's rule (cornac_tpu/models/mter.py): max(size, n - n % size)
    want = tuple(max(WORLD, n - n % WORLD) for n in ODD_COUNTS.values())
    assert want == (256, 256)
    assert tuple(ranks["odd counts"]) == want


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
