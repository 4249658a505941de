"""The port's neighbourhood models and co-support cosine top-k against the
JAX package's, on the same seeded inputs.

On the CPU the port's ``cosine_topk`` runs its plain version; the JAX
function runs its XLA path and its Pallas kernel in interpret mode.
Tolerances:

- exact: on star ratings with no weighting every product is a multiple of
  0.25 and every sum is exact in float32, so similarities, neighbour
  tables and the scores built on them must agree bit for bit;
- elsewhere (mean-centred, pearson, idf/bm25, random weights): rtol 1e-5 /
  atol 1e-6 (float32 products summed in another order), and a neighbour
  index may differ only where the similarity it carries agrees within
  that tolerance with the one it displaced (a near-tie).

The CUDA kernel reads W as two compressed views (CSR and CSC) built on
the device; on the CPU the sparse entry point densifies those views and
runs the plain version, so the tests below hold the views to scipy (their
support is ``float32(W) != 0``, duplicates summed first, as the dense
``[W != 0]`` of the JAX kernel means) and the answers built on them to the
JAX function. The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py`` and ``test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix, csr_matrix

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.models import ItemKNN as JItemKNN, UserKNN as JUserKNN
from cornac_tpu.models.knn import compute_similarity as j_compute_similarity
from cornac_tpu.ops.pallas_similarity import cosine_topk as j_cosine_topk
from cornac_tpu_torch.convert import knn_from_arrays
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.models import ItemKNN, Recommender, UserKNN
from cornac_tpu_torch.models.knn import _topk_lower_index, compute_similarity, dense_f32
from cornac_tpu_torch.ops.cosine_topk import (
    COSINE_TOPK, SparseViews, cosine_topk, cosine_topk_sparse, cosine_topk_torch, dense_views,
    scipy_views)

cornac_tpu_torch.set_default_device("cpu")

RTOL, ATOL = 1e-5, 1e-6
JAX_PATHS = ["xla", "pallas_interpret"]


# ---------------------------------------------------------------- inputs


def _W(n=150, m=60, density=0.25, centered=False, seed=4):
    """The matrices of the JAX package's Pallas similarity tests: sparse
    random weights (many rows share no column: tied zero similarities),
    optionally mean-centred so genuinely negative similarities occur."""
    rng = np.random.RandomState(seed)
    W = rng.randn(n, m).astype(np.float32)
    W[rng.rand(n, m) >= density] = 0.0
    if centered:
        for r in range(n):
            nz = W[r] != 0
            if nz.any():
                W[r, nz] -= W[r, nz].mean() - 1e-4
    return W


def _W_exact(kind, n=90, m=70, density=0.12, seed=9):
    """Star-rated weights on which every sum is exact in float32."""
    rng = np.random.RandomState(seed)
    values = {
        "binary": np.ones((n, m)),
        "integer": rng.randint(1, 6, (n, m)),
        "half_star": rng.randint(1, 11, (n, m)) / 2.0,
    }[kind]
    W = np.where(rng.rand(n, m) < density, values, 0.0).astype(np.float32)
    W[3] = 0.0  # an all-zero row: every similarity 0, the first k other rows
    return W


def _j_cosine(W):
    from cornac_tpu.models.knn import _co_support_cosine

    return np.asarray(_co_support_cosine(np.asarray(W)), dtype=np.float64)


def assert_topk_near(s, i, s_ref, i_ref, sim):
    """Similarities within tolerance; an index may differ from the
    reference only where the similarity it carries (read from the full
    matrix ``sim``) matches the reference's at that position."""
    s, i = np.asarray(s), np.asarray(i)
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    assert i.shape == i_ref.shape and i.dtype == np.int32
    np.testing.assert_allclose(s, s_ref, rtol=RTOL, atol=ATOL)
    picked = np.take_along_axis(sim, i.astype(np.int64), axis=1)
    bad = i != i_ref
    np.testing.assert_allclose(picked[bad], s_ref[bad], rtol=RTOL, atol=ATOL)
    for row in i:
        assert len(set(row.tolist())) == len(row)


def _star_triples(seed=0, n_users=60, n_items=90, n=900, half=False):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        r = rng.randint(1, 11) / 2.0 if half else float(rng.randint(1, 6))
        rows.append((f"u{rng.randint(n_users)}", f"i{rng.randint(n_items)}", r))
    return rows


def _both(triples):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # duplicate pairs are dropped
        return Dataset.from_uir(triples, seed=1), JDataset.from_uir(triples, seed=1)


# ---------------------------------------------------------- cosine_topk


@pytest.mark.parametrize("jax_path", JAX_PATHS)
@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("centered", [False, True])
def test_cosine_topk_matches_jax(jax_path, exclude_self, centered):
    # centred: k past n, so the whole row is ranked and the negative
    # similarities must stay above the masked padding of the JAX tiles
    W = _W(centered=centered)
    k = 200 if centered else 10
    s, i = cosine_topk(W, k, exclude_self=exclude_self)
    s_ref, i_ref = j_cosine_topk(W, k, exclude_self=exclude_self, force=jax_path)
    sim = _j_cosine(W)
    if exclude_self:
        np.fill_diagonal(sim, -3e38)
        assert not (i.numpy() == np.arange(W.shape[0])[:, None]).any()
    assert_topk_near(s, i, s_ref, i_ref, sim)
    if centered:
        assert (s.numpy() < 0).any()  # negative neighbours are ranked


@pytest.mark.parametrize("jax_path", JAX_PATHS)
@pytest.mark.parametrize("kind", ["binary", "integer", "half_star"])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_cosine_topk_exact_on_star_ratings(jax_path, kind, exclude_self):
    # most similarities tie (1.0 on binary data, 0.0 wherever two rows
    # share no column): the order inside each tie is the whole answer
    W = _W_exact(kind)
    s, i = cosine_topk(W, 25, exclude_self=exclude_self)
    s_ref, i_ref = j_cosine_topk(W, 25, exclude_self=exclude_self, force=jax_path)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    others = [c for c in range(W.shape[0]) if not (exclude_self and c == 3)]
    np.testing.assert_array_equal(i.numpy()[3], others[:25])  # the all-zero row


@pytest.mark.parametrize("exclude_self,n,want", [(True, 20, 19), (False, 20, 20), (True, 1, 0)])
def test_cosine_topk_caps_k(exclude_self, n, want):
    W = _W(n=n, m=10)
    s, i = cosine_topk(W, 50, exclude_self=exclude_self)
    s_ref, i_ref = j_cosine_topk(W, 50, exclude_self=exclude_self, force="xla")
    assert s.shape == i.shape == np.asarray(s_ref).shape == (n, want)
    sim = _j_cosine(W)
    if exclude_self:
        np.fill_diagonal(sim, -3e38)
    assert_topk_near(s, i, s_ref, i_ref, sim)


def test_cosine_topk_matches_its_full_matrix():
    W = _W(n=90, m=40)
    sim = _j_cosine(W)
    np.fill_diagonal(sim, -np.inf)
    s, _ = cosine_topk(W, 7)
    np.testing.assert_allclose(s.numpy(), -np.sort(-sim, axis=1)[:, :7], rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    W = torch.from_numpy(_W(n=40, m=30))
    before = COSINE_TOPK.launches
    s, i = cosine_topk(W, 6)
    assert COSINE_TOPK.launches == before
    s_ref, i_ref = cosine_topk_torch(W, 6)
    assert torch.equal(s, s_ref) and torch.equal(i, i_ref) and i.dtype == torch.int32


def test_kernel_refuses_cpu_tensors():
    W = _W(n=40, m=30)
    with pytest.raises(ValueError):
        cosine_topk(W, 5, force="kernel")
    with pytest.raises(ValueError):
        COSINE_TOPK(torch.from_numpy(W), 5)
    with pytest.raises(ValueError):
        cosine_topk(W, 5, force="pallas")


def test_topk_lower_index_orders_ties_as_lax_top_k():
    import jax

    rng = np.random.RandomState(2)
    w = rng.randint(-2, 3, (7, 5, 40)).astype(np.float32)
    w[w == 2] = -np.inf
    w[0, 0, :3] = [0.0, -0.0, 0.0]
    for k in (1, 6, 40):
        vals, idx = _topk_lower_index(torch.from_numpy(w), k)
        j_vals, j_idx = jax.lax.top_k(w, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


# ------------------------------------------------------ compute_similarity


@pytest.mark.parametrize("chunk", [2048, 16])  # whole matrix, then 16-row blocks
@pytest.mark.parametrize("exact", [True, False])
def test_compute_similarity_matches_jax(chunk, exact):
    from scipy.sparse import csr_matrix

    W = csr_matrix(_W_exact("integer") if exact else _W(centered=True))
    got = compute_similarity(W, chunk=chunk)
    want = j_compute_similarity(W, chunk=chunk)
    assert got.dtype == np.float64 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, compute_similarity(W), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- models

# the KNN configurations of the JAX package's model tests, then bm25 and
# amplify on both sides; "exact" marks those whose similarities are exact
CONFIGS = [
    (UserKNN, JUserKNN, dict(), True),
    (ItemKNN, JItemKNN, dict(), True),
    (UserKNN, JUserKNN, dict(similarity="pearson", weighting="idf"), False),
    (ItemKNN, JItemKNN, dict(mean_centered=True, weighting="bm25"), False),
    (UserKNN, JUserKNN, dict(weighting="bm25"), False),
    (ItemKNN, JItemKNN, dict(weighting="bm25"), False),
    (UserKNN, JUserKNN, dict(amplify=2.0), True),
    (ItemKNN, JItemKNN, dict(amplify=2.0), True),
]


def _config_id(config):
    cls, _, kwargs, _ = config
    return cls.__name__ + "-" + ("-".join(f"{k}={v}" for k, v in kwargs.items()) or "default")


def _carried(jmodel, cls):
    """The JAX model's fitted arrays, carried into a port model."""
    w = jmodel._weight_mat.tocsr()
    meta = {name: getattr(jmodel, name) for name in (
        "k", "similarity", "mean_centered", "weighting", "amplify", "num_users",
        "num_items", "uid_map", "iid_map", "min_rating", "max_rating", "global_mean")}
    arrays = dict(sim_mat=jmodel.sim_mat, ui_centered=jmodel.ui_centered,
                  mean_arr=jmodel.mean_arr, data=w.data, indices=w.indices,
                  indptr=w.indptr, shape=w.shape)
    return knn_from_arrays(cls.__name__, arrays, meta, device="cpu")


def _assert_same_scoring(port, jmodel, tol):
    users = np.arange(-1, jmodel.total_users + 1)  # unknown users at both ends
    np.testing.assert_allclose(port.score_batch(users), jmodel.score_batch(users), **tol)
    np.testing.assert_allclose(port.score(2), jmodel.score(2), **tol)
    assert abs(port.score(2, 5) - jmodel.score(2, 5)) <= tol["atol"] + tol["rtol"] * abs(jmodel.score(2, 5))
    r_port, s_port = port.rank(4, k=5)
    r_jax, s_jax = jmodel.rank(4, k=5)
    np.testing.assert_allclose(s_port, s_jax, **tol)
    if tol["rtol"] == 0:
        np.testing.assert_array_equal(r_port, r_jax)
    rng = np.random.RandomState(5)
    u = rng.randint(0, jmodel.total_users, 40)
    i = rng.randint(0, jmodel.total_items, 40)
    np.testing.assert_allclose(port.rate_batch(u, i), jmodel.rate_batch(u, i), **tol)


@pytest.fixture(scope="module")
def star_data():
    return _both(_star_triples())


@pytest.mark.parametrize("config", CONFIGS, ids=_config_id)
def test_fit_matches_jax(star_data, config):
    cls, jcls, kwargs, exact = config
    train, jtrain = star_data
    port = cls(k=3, verbose=False, **kwargs).fit(train)
    jmodel = jcls(k=3, verbose=False, **kwargs).fit(jtrain)
    np.testing.assert_array_equal(port.ui_centered, jmodel.ui_centered)
    np.testing.assert_array_equal(port.mean_arr, jmodel.mean_arr)
    assert (port._weight_mat != jmodel._weight_mat).nnz == 0
    if exact:
        np.testing.assert_array_equal(port.sim_mat, jmodel.sim_mat)
        # the whole scoring path on the port's own fit
        _assert_same_scoring(port, jmodel, dict(rtol=RTOL, atol=ATOL))
    else:
        np.testing.assert_allclose(port.sim_mat, jmodel.sim_mat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("config", CONFIGS, ids=_config_id)
def test_scoring_matches_jax_on_the_same_fit(star_data, config):
    # both packages score from the same fitted arrays, so near-ties in the
    # similarities cannot pick different neighbours: only the order of the
    # float32 sums differs
    cls, jcls, kwargs, _ = config
    jmodel = jcls(k=3, verbose=False, **kwargs).fit(star_data[1])
    _assert_same_scoring(_carried(jmodel, cls), jmodel, dict(rtol=RTOL, atol=ATOL))


@pytest.mark.parametrize("config", CONFIGS, ids=_config_id)
def test_neighbors_match_jax(star_data, config):
    cls, jcls, kwargs, exact = config
    train, jtrain = star_data
    port = cls(k=3, verbose=False, **kwargs).fit(train)
    jmodel = jcls(k=3, verbose=False, **kwargs).fit(jtrain)
    attr = "nearest_users" if cls is UserKNN else "nearest_items"
    ids, sims = getattr(port, attr)(num_neighbors=6)
    j_ids, j_sims = getattr(jmodel, attr)(num_neighbors=6, force="xla")
    if exact:
        np.testing.assert_array_equal(ids, np.asarray(j_ids))
        np.testing.assert_array_equal(sims, np.asarray(j_sims))
    else:
        sim = _j_cosine(np.asarray(jmodel._weight_mat.todense(), np.float32))
        np.fill_diagonal(sim, -3e38)
        if kwargs.get("amplify", 1.0) == 1.0:
            assert_topk_near(sims.astype(np.float32), ids, np.asarray(j_sims, np.float32),
                             np.asarray(j_ids), sim)
    # caching: a smaller table is a prefix, rows select, a larger one rebuilds
    sub_ids, sub_sims = port.neighbors([0, 2], num_neighbors=2)
    np.testing.assert_array_equal(sub_ids, ids[[0, 2], :2])
    np.testing.assert_array_equal(sub_sims, sims[[0, 2], :2])
    assert port.neighbors(num_neighbors=8)[0].shape[1] == 8


def test_ties_on_the_topk_boundary_pick_lower_indices():
    # u0 shares exactly one item (i0) with each of u1..u4, so all four are
    # 1.0-similar to u0, and they rated i9 differently. With k=2, u1 and u2
    # (the lower indices) must be the neighbours that vote: mean 3 + (0.5 -
    # 0.5)/2 = 3.0; any other pair gives another score.
    user_rows = [
        ("u0", "i0", 4.0), ("u0", "i5", 2.0),
        ("u1", "i0", 4.0), ("u1", "i9", 5.0),
        ("u2", "i0", 2.0), ("u2", "i9", 1.0),
        ("u3", "i0", 5.0), ("u3", "i9", 2.0),
        ("u4", "i0", 3.0), ("u4", "i9", 5.0),
    ]
    # u0 rated a1..a4 (1, 2, 4, 5); each a_j shares one rater v_j with t,
    # so all four are 1.0-similar to t. With k=2, a1 and a2 vote:
    # mean 3 + (-2 - 1)/2 = 1.5
    item_rows = [("u0", f"a{j}", float(r)) for j, r in zip(range(1, 5), (1, 2, 4, 5))]
    item_rows += [(f"v{j}", x, 3.0) for j in range(1, 5) for x in (f"a{j}", "t")]
    for rows, cls, jcls, user, item, want in (
        (user_rows, UserKNN, JUserKNN, "u0", "i9", 3.0),
        (item_rows, ItemKNN, JItemKNN, "u0", "t", 1.5),
    ):
        train, jtrain = _both(rows)
        port = cls(k=2, verbose=False).fit(train)
        jmodel = jcls(k=2, verbose=False).fit(jtrain)
        u, i = train.uid_map[user], train.iid_map[item]
        assert port.score(u, i) == pytest.approx(want, abs=1e-6)
        assert port.score(u, i) == pytest.approx(jmodel.score(u, i), abs=1e-6)
        np.testing.assert_allclose(port.score_batch(np.arange(train.num_users)),
                                   jmodel.score_batch(np.arange(train.num_users)),
                                   rtol=RTOL, atol=ATOL)


def test_half_star_exact_scoring():
    train, jtrain = _both(_star_triples(seed=3, half=True))
    for cls, jcls in ((UserKNN, JUserKNN), (ItemKNN, JItemKNN)):
        port = cls(k=4, verbose=False).fit(train)
        jmodel = jcls(k=4, verbose=False).fit(jtrain)
        np.testing.assert_array_equal(port.sim_mat, jmodel.sim_mat)
        _assert_same_scoring(port, jmodel, dict(rtol=RTOL, atol=ATOL))


def test_knn_from_arrays_carries_a_jax_model(star_data):
    jmodel = JItemKNN(k=4, verbose=False).fit(star_data[1])
    port = _carried(jmodel, ItemKNN)
    assert port.is_fitted and port.uid_map == jmodel.uid_map
    ids, sims = port.nearest_items(num_neighbors=5)
    j_ids, j_sims = jmodel.nearest_items(num_neighbors=5, force="xla")
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(sims, np.asarray(j_sims))
    assert port.recommend(jmodel.user_ids[0], k=5) == jmodel.recommend(jmodel.user_ids[0], k=5)
    with pytest.raises(ValueError):
        knn_from_arrays("MF", {}, {})
    with pytest.raises(KeyError):
        knn_from_arrays("UserKNN", {}, {"k": 3})


def test_save_load_rebuilds_device_copies(star_data, tmp_path):
    model = UserKNN(k=3, verbose=False).fit(star_data[0])
    before = model.score_batch(np.arange(5))
    assert model._resident_d is not None
    loaded = Recommender.load(model.save(str(tmp_path)))
    assert getattr(loaded, "_resident_d", None) is None
    np.testing.assert_array_equal(loaded.score_batch(np.arange(5)), before)


def test_refit_drops_the_old_tables(star_data):
    train, _ = star_data
    model = ItemKNN(k=3, verbose=False).fit(train)
    model.nearest_items(num_neighbors=4)
    model.score_batch(np.arange(3))
    small, _ = _both(_star_triples(seed=8, n_users=20, n_items=30, n=200))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # re-fitting warns
        model.fit(small)
    assert model.nearest_items(num_neighbors=4)[0].shape[0] == small.num_items
    assert model.score_batch(np.arange(3)).shape[1] == small.num_items


def test_invalid_options_raise():
    with pytest.raises(ValueError):
        UserKNN(similarity="jaccard")
    with pytest.raises(ValueError):
        ItemKNN(weighting="tfidf")


# ------------------------------------------------- sparse views of W

CPU = torch.device("cpu")


def _awkward(n=40, m=30, seed=0):
    """A COO matrix with every case the views must get right: explicit
    zeros, duplicates (some summing to 0), a value that rounds to 0 in
    float32, an all-zero row and an all-zero column."""
    rng = np.random.RandomState(seed)
    rows, cols = rng.randint(n, size=300), rng.randint(m, size=300)
    keep = (rows != 5) & (cols != 7)  # row 5 and column 7 stay empty
    rows, cols = rows[keep], cols[keep]
    vals = rng.randint(1, 6, size=len(rows)).astype(np.float64)
    rows = np.concatenate([rows, [0, 1, 2, 2, 3, 3, 4]])
    cols = np.concatenate([cols, [1, 2, 3, 3, 4, 4, 8]])
    vals = np.concatenate([vals, [0.0, 0.0, 2.5, -2.5, 1.5, 1.0, 1e-50]])
    return coo_matrix((vals, (rows, cols)), shape=(n, m))


def _scipy_reference(mat):
    """What the views must hold, by scipy alone: duplicates summed in
    float64, cast to float32, zeros dropped, indices sorted."""
    coo = coo_matrix(mat, copy=True)
    coo.sum_duplicates()
    csr = csr_matrix((coo.data.astype(np.float32), (coo.row, coo.col)), shape=coo.shape)
    csr.eliminate_zeros()
    csr.sort_indices()
    csc = csr.tocsc()
    csc.sort_indices()
    return csr, csc


def _assert_views(views, mat):
    csr, csc = _scipy_reference(mat)
    assert isinstance(views, SparseViews) and views.shape == csr.shape
    for got, want in ((views.row_ptr, csr.indptr), (views.col_idx, csr.indices),
                      (views.col_ptr, csc.indptr), (views.row_idx, csc.indices)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in ((views.row_val, csr.data), (views.col_val, csc.data)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_scipy_views_match_scipy(seed):
    mat = _awkward(seed=seed)
    views = scipy_views(mat, CPU)
    _assert_views(views, mat)
    assert views.row_ptr[5] == views.row_ptr[6]  # the empty row
    assert views.col_ptr[7] == views.col_ptr[8]  # the empty column
    assert 1e-50 not in views.row_val.tolist()  # rounded to 0, dropped
    # the same matrix as the dense float32 W the models used to build
    np.testing.assert_array_equal(views.dense().numpy(), dense_f32(mat, CPU).numpy())


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_scipy_views_take_every_format(fmt):
    mat = _awkward(seed=2)
    _assert_views(scipy_views(mat.asformat(fmt), CPU), mat)


def test_dense_views_match_scipy():
    W = _W(n=50, m=35, density=0.3, centered=True)
    views = dense_views(torch.from_numpy(W))
    _assert_views(views, coo_matrix(W))
    np.testing.assert_array_equal(views.dense().numpy(), W)


def test_views_of_an_empty_matrix():
    views = scipy_views(coo_matrix((4, 3)), CPU)
    assert views.row_ptr.tolist() == [0] * 5 and views.col_ptr.tolist() == [0] * 4
    assert views.col_idx.numel() == views.row_idx.numel() == 0


@pytest.mark.parametrize("kind", ["binary", "integer", "half_star"])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_sparse_entry_exact_on_star_ratings(kind, exclude_self):
    W = _W_exact(kind)
    s, i = cosine_topk_sparse(csr_matrix(W), 25, exclude_self=exclude_self)
    s_ref, i_ref = j_cosine_topk(W, 25, exclude_self=exclude_self, force="xla")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_sparse_entry_exact_with_explicit_zeros_and_duplicates():
    mat = _awkward(seed=3)
    W = dense_f32(mat, CPU).numpy()  # what the JAX models densify the same entries to
    s, i = cosine_topk_sparse(mat, 12)
    s_ref, i_ref = j_cosine_topk(W, 12, force="xla")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # row 5 has no entry: its neighbours are the first 12 other rows, at 0
    np.testing.assert_array_equal(i.numpy()[5], [r for r in range(13) if r != 5])


@pytest.mark.parametrize("exclude_self", [True, False])
def test_sparse_entry_near_jax_on_centred_data(exclude_self):
    W = _W(centered=True)
    s, i = cosine_topk_sparse(csr_matrix(W), 200, exclude_self=exclude_self)
    s_ref, i_ref = j_cosine_topk(W, 200, exclude_self=exclude_self, force="xla")
    sim = _j_cosine(W)
    if exclude_self:
        np.fill_diagonal(sim, -3e38)
    assert_topk_near(s, i, s_ref, i_ref, sim)
    assert (s.numpy() < 0).any()


def test_sparse_and_dense_entries_agree():
    W = _W(n=70, m=50)
    s, i = cosine_topk_sparse(csr_matrix(W), 9)
    s_d, i_d = cosine_topk(W, 9)
    assert torch.equal(s, s_d) and torch.equal(i, i_d)


@pytest.mark.parametrize("exclude_self,n,want", [(True, 1, 0), (False, 3, 3)])
def test_sparse_entry_caps_k(exclude_self, n, want):
    s, i = cosine_topk_sparse(csr_matrix(_W(n=n, m=10)), 50, exclude_self=exclude_self)
    assert s.shape == i.shape == (n, want)


def test_sparse_entry_on_cpu_takes_the_plain_version():
    before = COSINE_TOPK.launches
    cosine_topk_sparse(csr_matrix(_W(n=30, m=20)), 4)
    assert COSINE_TOPK.launches == before
    with pytest.raises(ValueError):
        cosine_topk_sparse(csr_matrix(_W(n=30, m=20)), 4, force="kernel")
    with pytest.raises(ValueError):  # views on the CPU never reach the kernel
        COSINE_TOPK(scipy_views(csr_matrix(_W(n=30, m=20)), CPU), 4)


@pytest.mark.parametrize("cls,jcls,half", [
    (UserKNN, JUserKNN, False), (ItemKNN, JItemKNN, False),
    (UserKNN, JUserKNN, True), (ItemKNN, JItemKNN, True)])
def test_nearest_through_the_sparse_path_match_jax(cls, jcls, half):
    # mean-centred star ratings hold exact zeros as EPS = 1e-8, which
    # float32 keeps nonzero: the views keep them in the support too
    train, jtrain = _both(_star_triples(seed=11, half=half))
    port = cls(k=3, mean_centered=False, verbose=False).fit(train)
    jmodel = jcls(k=3, mean_centered=False, verbose=False).fit(jtrain)
    attr = "nearest_users" if cls is UserKNN else "nearest_items"
    ids, sims = getattr(port, attr)(num_neighbors=7)
    j_ids, j_sims = getattr(jmodel, attr)(num_neighbors=7, force="xla")
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(sims, np.asarray(j_sims))


def test_eps_entries_stay_in_the_support():
    # UserKNN(mean_centered=True) weighs by ui_centered, where a rating
    # equal to its user's mean is stored as EPS = 1e-8
    rows = [("u0", "i0", 3.0), ("u0", "i1", 3.0), ("u1", "i0", 2.0), ("u1", "i1", 4.0),
            ("u2", "i1", 5.0), ("u2", "i2", 1.0)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train, jtrain = _both(rows)
    port = UserKNN(k=2, mean_centered=True, verbose=False).fit(train)
    assert (port._weight_mat.data == 1e-8).any()
    views = scipy_views(port._weight_mat, CPU)
    assert views.row_val.numel() == port._weight_mat.nnz
    jmodel = JUserKNN(k=2, mean_centered=True, verbose=False).fit(jtrain)
    ids, sims = port.nearest_users(num_neighbors=2)
    j_ids, j_sims = jmodel.nearest_users(num_neighbors=2, force="xla")
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(sims, np.asarray(j_sims), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,C", [(40, 30, 40), (40, 30, 15), (7, 3, 100), (300, 1, 64)])
def test_partition_gives_each_warp_its_rows(n, m, C):
    # the kernel's warps own spans of consecutive candidate rows; split
    # must hand each warp exactly the CSC entries of its span, in every
    # column, and the ranges must fit one pass of shared memory (C rows)
    from cornac_tpu_torch.ops.cosine_topk import WARPS, partition

    views = dense_views(torch.from_numpy(_W(n=n, m=m, density=0.3, seed=n + m)))
    bounds, split = partition(views, C)
    b = bounds.long().tolist()
    ranges = len(b) // WARPS
    assert len(b) == ranges * WARPS + 1 and ranges == -(-n // C)
    assert b[0] == 0 and b[-1] == n and b == sorted(b)
    for q in range(ranges):
        assert b[(q + 1) * WARPS] - b[q * WARPS] <= C
    col_ptr, row_idx = views.col_ptr.tolist(), views.row_idx.tolist()
    assert split.shape == (m, len(b)) and split.dtype == torch.int32
    for j in range(m):
        for t, bound in enumerate(b):
            lo, hi = col_ptr[j], col_ptr[j + 1]
            want = lo + sum(1 for e in range(lo, hi) if row_idx[e] < bound)
            assert split[j, t] == want


def test_partition_balances_the_work():
    # a skewed matrix: low row indices are rated far more often; each warp's
    # share of the pair updates stays within one row's work of an equal share
    from cornac_tpu_torch.ops.cosine_topk import WARPS, partition

    rng = np.random.RandomState(0)
    n, m = 400, 300
    p_row = np.arange(1, n + 1) ** -1.0
    rows = rng.choice(n, size=8000, p=p_row / p_row.sum())
    mat = coo_matrix((np.ones(8000), (rows, rng.randint(m, size=8000))), shape=(n, m))
    views = scipy_views(mat, CPU)
    bounds, _ = partition(views, n)
    counts = torch.diff(views.col_ptr.long())
    row_of = torch.repeat_interleave(torch.arange(n), torch.diff(views.row_ptr.long()))
    work = torch.zeros(n, dtype=torch.float64).index_add_(
        0, row_of, counts[views.col_idx.long()].double())
    b = bounds.long().tolist()
    shares = [float(work[b[w]:b[w + 1]].sum()) for w in range(WARPS)]
    assert max(shares) <= sum(shares) / WARPS + float(work.max())
