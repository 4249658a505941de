"""The port's multi-device runtime (``cornac_tpu_torch.parallel`` and the
``mesh=`` branches) on a group of four gloo ranks on the CPU, against the
port's single-device runs and the JAX package's sharded functions.

The module-scoped fixture ``ranks`` starts this file as a script four
times (``python tests/test_torch_parallel.py <rank> <port> <outdir>``), one
process a rank, joined by ``init_distributed`` at ``tcp://127.0.0.1``. The
ranks run every case on the (data, model) layouts (4, 1), (2, 2) and (1, 4),
and once more with ``LOCAL_WORLD_SIZE=2`` posing as two hosts of two ranks;
rank 0 writes the results, and each test below compares one case. The JAX
side runs here, in the pytest process, on conftest's 8 virtual CPU devices.
It mirrors ``tests/test_parallel.py`` (the JAX package's, a slow file):

- the helpers: ``make_mesh``'s validation and shapes, ``init_distributed``
  as a no-op, the sharding helpers' placements (the JAX package's
  partition specs), ``row_shard_lookup`` equal to the JAX function,
  ``row_shard_scatter_add`` equal on the JAX test's inputs and within rtol
  1e-6 on seeded floats, ``sharded_topk`` with the same ids and scores
  within rtol 1e-5 (with and without a bias, and with ties across shards,
  where the scores are integers and equal exactly), ``pad_rows_for_mesh``;
- BPR, WBPR, MMMF, MF (SGD and adam), SVD and BaselineOnly: the mesh fit
  equals the single-device fit bit for bit on every layout; each rank runs
  one thread, as the single-device fit does;
- two hosts: each model group stays inside one host, and BPR's scores
  equal the single-process fit's;
- ``RatioSplit(mesh=)``: the metrics equal the plain evaluation's, and
  ``batch_eval_device(mesh=)`` equals the plain program and lies within
  rtol 1e-6 of the JAX package's sharded program on the same scores;
- ``TPUExactANN(mesh=)``: dot, cosine and L2 give the ids of the plain
  index and of the JAX package's sharded index;
- save/load/clone under a mesh, and a mesh fit stopped and resumed from
  its checkpoints, equal to the uninterrupted mesh fit.
"""

import datetime
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAYOUTS = {"4x1": 4, "2x2": 2, "1x4": 1}  # name: data_parallel
FITS = ("BPR", "WBPR", "MMMF", "MF", "MF-adam", "SVD", "BaselineOnly")
MEASURES = ("dot", "cosine", "l2")
METRIC_NAMES = ("AUC", "NDCG@10", "Recall@5")


# ---------------------------------------------------------------------- #
# inputs, the same on both sides
# ---------------------------------------------------------------------- #
def _rating_data(seed, n_users, n_items, n, stars=True):
    rng = np.random.RandomState(seed)
    return [(f"u{rng.randint(n_users)}", f"i{rng.randint(n_items)}",
             float(rng.randint(1, 6)) if stars else 1.0) for _ in range(n)]


def _lookup_inputs():
    table = np.random.RandomState(0).rand(16, 5).astype(np.float32)
    return table, np.array([0, 3, 7, 15, 8, 4], np.int64)


def _scatter_inputs():
    rng = np.random.RandomState(5)
    return (rng.rand(16, 4).astype(np.float32), rng.randint(16, size=40),
            rng.randn(40, 4).astype(np.float32))


def _topk_inputs(case):
    rng = np.random.RandomState(1)
    users = rng.rand(6, 4).astype(np.float32)
    items = rng.rand(32, 4).astype(np.float32)
    bias = rng.rand(32).astype(np.float32)
    if case == "ties":  # integer scores, each item twice: ties inside and across shards
        users = rng.randint(-2, 3, size=(6, 4)).astype(np.float32)
        items = rng.randint(-2, 3, size=(32, 4)).astype(np.float32)
        items[16:] = items[:16]
    return users, items, (bias if case == "bias" else None), (8 if case == "ties" else 5)


def _eval_inputs():
    rng = np.random.RandomState(21)
    scores = np.round(rng.rand(37, 101), 1).astype(np.float32)  # rounded: ties
    pos = rng.rand(37, 101) < 0.08
    pos[np.arange(37), rng.randint(101, size=37)] = True
    cand = pos | (rng.rand(37, 101) < 0.7)
    return scores, pos, cand


def _ann_params():
    rng = np.random.RandomState(2)
    return {"U": rng.randn(20, 6).astype(np.float32), "V": rng.randn(64, 6).astype(np.float32),
            "Bu": rng.randn(20).astype(np.float32), "Bi": rng.randn(64).astype(np.float32)}


# ---------------------------------------------------------------------- #
# the ranks (this file run as a script)
# ---------------------------------------------------------------------- #
def _fit_model(name, mesh, train):
    from cornac_tpu_torch import models as P

    kw = dict(max_iter=5, seed=11, mesh=mesh)
    if name in ("BPR", "WBPR", "MMMF"):
        return getattr(P, name)(k=4, batch_size=400, **kw).fit(train)
    if name == "MF-adam":
        return P.MF(k=4, optimizer="adam", **kw).fit(train)
    if name == "BaselineOnly":
        return P.BaselineOnly(**kw).fit(train)
    return getattr(P, name)(k=4, **kw).fit(train)


def _params(model):
    return {a: np.asarray(getattr(model, a)) for a in ("u_factors", "i_factors", "u_biases",
                                                         "i_biases")
            if getattr(model, a, None) is not None}


def _rank_main(rank, port, outdir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import cornac_tpu_torch
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, MAP, MRR, NDCG, Recall
    from cornac_tpu_torch.metrics.ranking import batch_eval_device, metric_device_specs
    from cornac_tpu_torch.models import BPR, MF, TPUExactANN
    from cornac_tpu_torch.models.recommender import MEASURE_COSINE, MEASURE_L2, Recommender
    from cornac_tpu_torch.ops.fused_topk import fused_topk
    from cornac_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        pad_rows_to_multiple,
        replicate_all,
        shard_batch,
        shard_replicated,
        shard_rows,
        shard_tables,
    )
    from cornac_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
    from cornac_tpu_torch.parallel.sharded import (
        pad_rows_for_mesh,
        row_shard_lookup,
        row_shard_scatter_add,
        sharded_topk,
    )

    cornac_tpu_torch.set_default_device("cpu")
    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=WORLD,
                     process_id=rank, timeout=datetime.timedelta(seconds=120))
    init_distributed()  # a no-op once the group exists
    out = {}
    fit_split = RatioSplit(data=_rating_data(3, 30, 50, 500), test_size=0.2,
                           rating_threshold=2.5, seed=123)
    train = fit_split.train_set
    if rank == 0:  # the single-device fits, one thread as each rank
        for name in FITS:
            out["plain", name] = _params(_fit_model(name, None, train))
    try:
        make_mesh(data_parallel=3)
    except ValueError as e:
        out["validation"] = str(e)
    eval_kw = dict(data=_rating_data(9, 30, 60, 700, stars=False), test_size=0.2,
                   rating_threshold=0.5, seed=42)
    metrics = lambda: [AUC(), NDCG(k=10), Recall(k=5)]  # noqa: E731
    plain_eval, _ = RatioSplit(**eval_kw).evaluate(BPR(k=4, max_iter=5, seed=7), metrics(),
                                                   user_based=True, show_validation=False)
    out["eval", "plain"] = [plain_eval.metric_avg_results[n] for n in METRIC_NAMES]
    scores, pos, cand = _eval_inputs()
    specs = metric_device_specs([AUC(), NDCG(k=10), Recall(k=5), MAP(), MRR()])
    out["batch_eval", "plain"] = batch_eval_device(torch.as_tensor(scores), pos, cand, specs)
    ann_split = RatioSplit(data=_rating_data(2, 20, 64, 400), test_size=0.2, seed=1)
    ann_model = MF(k=6, init_params=_ann_params(), trainable=False).fit(ann_split.train_set)

    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        out["shape", layout] = (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))
        table, ids = _lookup_inputs()
        out["lookup", layout] = row_shard_lookup(mesh, shard_rows(mesh, table),
                                                 torch.as_tensor(ids)).numpy()
        zeros = shard_rows(mesh, torch.zeros(16, 3))
        row_shard_scatter_add(mesh, zeros, torch.tensor([1, 1, 9, 15]), torch.ones(4, 3))
        out["scatter_jax_inputs", layout] = zeros.full_tensor().numpy()
        table, ids, upd = _scatter_inputs()
        sharded = shard_rows(mesh, table)
        row_shard_scatter_add(mesh, sharded, torch.as_tensor(ids), torch.as_tensor(upd))
        out["scatter", layout] = sharded.full_tensor().numpy()
        for case in ("plain", "bias", "ties"):
            users, items, bias, k = _topk_inputs(case)
            s, i = sharded_topk(mesh, torch.as_tensor(users), shard_rows(mesh, items), k,
                                item_bias=None if bias is None else shard_rows(mesh, bias))
            ref = fused_topk(torch.as_tensor(users), torch.as_tensor(items), k,
                             bias=None if bias is None else torch.as_tensor(bias))
            out["topk", case, layout] = (s.numpy(), i.numpy(), ref[0].numpy(), ref[1].numpy())
        padded, n = pad_rows_for_mesh(np.ones((10, 2), np.float32), mesh)
        out["pad", layout] = (padded.shape[0], n)
        x = np.arange(24, dtype=np.float32).reshape(8, 3)
        placed = {"batch": shard_batch(mesh, x), "replicated": shard_replicated(mesh, x),
                  "rows": shard_rows(mesh, x)}
        table, none = shard_tables(mesh, np.ones((10, 2), np.float32), None)
        one = shard_tables(mesh, np.ones(10, np.float32))
        tree, absent = replicate_all(mesh, {"a": x, "b": [x[:2], None]}, None)
        out["helpers", layout] = dict(
            placed={k: (v.full_tensor().numpy(), tuple(v.to_local().shape),
                        [type(p).__name__ for p in v.placements]) for k, v in placed.items()},
            table=(tuple(table.shape), tuple(table.to_local().shape), none is None,
                   tuple(one.shape)),
            tree=(tree["a"].full_tensor().numpy(), tree["b"][0].full_tensor().numpy(),
                  tree["b"][1] is None, absent is None),
            padded=pad_rows_to_multiple(np.ones((10, 2), np.float32), 4).shape)

        for name in FITS:
            out["fit", name, layout] = _params(_fit_model(name, mesh, train))

        mesh_eval, _ = RatioSplit(mesh=mesh, **eval_kw).evaluate(
            BPR(k=4, max_iter=5, seed=7), metrics(), user_based=True, show_validation=False)
        out["eval", layout] = [mesh_eval.metric_avg_results[n] for n in METRIC_NAMES]
        out["batch_eval", layout] = batch_eval_device(torch.as_tensor(scores), pos, cand, specs,
                                                      mesh=mesh)

        q = ann_model.get_user_vectors()[:5]
        for measure in MEASURES:
            got = []
            for index in (TPUExactANN(ann_model), TPUExactANN(ann_model, mesh=mesh)):
                index.build_index()
                index.measure = {"dot": index.measure, "cosine": MEASURE_COSINE,
                                 "l2": MEASURE_L2}[measure]
                index._build_device_index()
                got.append(index.knn_query(q, 4))
            out["ann", measure, layout] = (got, index._rows_per_shard)

        if layout == "2x2":
            save_split = RatioSplit(data=_rating_data(6, 20, 30, 300, stars=False),
                                    test_size=0.2, rating_threshold=0.5, seed=5)
            m = BPR(k=4, max_iter=3, seed=8, mesh=mesh).fit(save_split.train_set)
            path = m.save(os.path.join(outdir, "saved"))
            paths = [None] * WORLD
            dist.all_gather_object(paths, path)
            loaded = Recommender.load(path)
            out["save"] = dict(clone_shares=m.clone().mesh is mesh, paths=paths,
                               loaded_mesh=loaded.mesh, loaded_u=loaded.u_factors,
                               u=m.u_factors, finite=bool(np.isfinite(loaded.score(0)).all()))
            for name, cls, kw in (("BPR", BPR, dict(k=4, batch_size=400, seed=5)),
                                  ("MF", MF, dict(k=4, seed=5))):
                ckpt = os.path.join(outdir, f"ckpt-{name}")
                straight = cls(max_iter=4, mesh=mesh, **kw).fit(train)
                cls(max_iter=2, mesh=mesh, **kw).enable_checkpointing(ckpt, every=1).fit(train)
                resumed = cls(max_iter=4, mesh=mesh, **kw).enable_checkpointing(ckpt, every=1)
                out["resume", name] = (_params(straight), _params(resumed.fit(train)),
                                       sorted(os.listdir(ckpt)))

    # two hosts of two ranks (LOCAL_WORLD_SIZE=2, as torchrun sets it)
    per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    mesh = make_mesh(data_parallel=2)
    groups = mesh.mesh.tolist()
    bpr = BPR(k=4, max_iter=5, seed=11, mesh=mesh).fit(train)
    out["two_hosts"] = ([{r // per_host for r in row} for row in groups],
                        bpr.score_batch(np.arange(8)))
    if rank == 0:
        plain = BPR(k=4, max_iter=5, seed=11).fit(train)
        out["two_hosts_plain"] = plain.score_batch(np.arange(8))
        with open(os.path.join(outdir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# pytest side
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("ranks")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(outdir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    with open(outdir / "results.pkl", "rb") as f:
        return pickle.load(f)


# the JAX side: each reference once for the module, whatever the layout
@functools.lru_cache(maxsize=None)
def _jmesh():
    from cornac_tpu.parallel import make_mesh

    return make_mesh(data_parallel=2)  # (2 data, 4 model) on conftest's 8 devices


@functools.lru_cache(maxsize=None)
def _jax_lookup():
    import jax.numpy as jnp

    from cornac_tpu.parallel import shard_rows
    from cornac_tpu.parallel.sharded import row_shard_lookup

    table, ids = _lookup_inputs()
    return np.asarray(row_shard_lookup(_jmesh(), shard_rows(_jmesh(), jnp.asarray(table)),
                                       jnp.asarray(ids, jnp.int32)))


@functools.lru_cache(maxsize=None)
def _jax_scatter():
    import jax.numpy as jnp

    from cornac_tpu.parallel import shard_rows
    from cornac_tpu.parallel.sharded import row_shard_scatter_add

    mesh = _jmesh()
    ones = row_shard_scatter_add(mesh, shard_rows(mesh, jnp.zeros((16, 3))),
                                 jnp.asarray([1, 1, 9, 15], jnp.int32), jnp.ones((4, 3)))
    table, ids, upd = _scatter_inputs()
    floats = row_shard_scatter_add(mesh, shard_rows(mesh, jnp.asarray(table)),
                                   jnp.asarray(ids, jnp.int32), jnp.asarray(upd))
    return np.asarray(ones), np.asarray(floats)


@functools.lru_cache(maxsize=None)
def _jax_topk(case):
    import jax.numpy as jnp

    from cornac_tpu.parallel import shard_replicated, shard_rows
    from cornac_tpu.parallel.sharded import sharded_topk

    mesh = _jmesh()
    users, items, bias, k = _topk_inputs(case)
    s, i = sharded_topk(mesh, shard_replicated(mesh, jnp.asarray(users)),
                        shard_rows(mesh, jnp.asarray(items)), k,
                        item_bias=None if bias is None else shard_rows(mesh, jnp.asarray(bias)))
    return np.asarray(s), np.asarray(i)


@functools.lru_cache(maxsize=None)
def _jax_batch_eval():
    from cornac_tpu.metrics import AUC, MAP, MRR, NDCG, Recall
    from cornac_tpu.metrics.ranking import batch_eval_device, metric_device_specs

    scores, pos, cand = _eval_inputs()
    specs = metric_device_specs([AUC(), NDCG(k=10), Recall(k=5), MAP(), MRR()])
    return batch_eval_device(scores, pos, cand, specs, mesh=_jmesh())


@functools.lru_cache(maxsize=None)
def _jax_ann_ids(measure):
    from cornac_tpu.eval_methods import RatioSplit as JRatioSplit
    from cornac_tpu.models import MF as JMF, TPUExactANN as JTPUExactANN
    from cornac_tpu.models.recommender import MEASURE_COSINE, MEASURE_L2

    split = JRatioSplit(data=_rating_data(2, 20, 64, 400), test_size=0.2, seed=1)
    model = JMF(k=6, init_params=_ann_params(), trainable=False).fit(split.train_set)
    index = JTPUExactANN(model, mesh=_jmesh())
    index.build_index()
    index.measure = {"dot": index.measure, "cosine": MEASURE_COSINE, "l2": MEASURE_L2}[measure]
    index._build_device_index()
    return index.knn_query(model.get_user_vectors()[:5], 4)[0]


def test_make_mesh_validation(ranks):
    assert "data_parallel=3 must divide device count 4" in ranks["validation"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_mesh_shapes(ranks, layout):
    dp = LAYOUTS[layout]
    assert ranks["shape", layout] == (dp, WORLD // dp)


def test_init_distributed_single_process_noop(monkeypatch):
    import torch.distributed as dist

    from cornac_tpu_torch.parallel import init_distributed

    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    init_distributed()  # single process, no coordinator: a silent no-op
    init_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_shard_lookup(ranks, layout):
    np.testing.assert_array_equal(ranks["lookup", layout], _jax_lookup())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_shard_scatter_add(ranks, layout):
    ones, floats = _jax_scatter()
    np.testing.assert_array_equal(ranks["scatter_jax_inputs", layout], ones)
    np.testing.assert_allclose(ranks["scatter", layout], floats, rtol=1e-6)


@pytest.mark.parametrize("case", ["plain", "bias", "ties"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_topk(ranks, layout, case):
    scores, ids, ref_scores, ref_ids = ranks["topk", case, layout]
    js, ji = _jax_topk(case)
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_array_equal(ids, ref_ids)  # the unsharded top-k's ids, ties included
    np.testing.assert_allclose(scores, js, rtol=1e-5)
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
    if case == "ties":
        np.testing.assert_array_equal(scores, ref_scores)
        assert (np.diff(scores, axis=1) == 0).any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharding_helpers(ranks, layout):
    # the JAX package's PartitionSpecs: rows P("model"), batches P("data"),
    # replicated P(); here the DTensor placements over ("data", "model")
    data, model = LAYOUTS[layout], WORLD // LAYOUTS[layout]
    got = ranks["helpers", layout]
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    want = {"batch": ((8 // data, 3), ["Shard", "Replicate"]),
            "replicated": ((8, 3), ["Replicate", "Replicate"]),
            "rows": ((8 // model, 3), ["Replicate", "Shard"])}
    for name, (local, placements) in want.items():
        full, got_local, got_placements = got["placed"][name]
        np.testing.assert_array_equal(full, x)
        assert (got_local, got_placements) == (local, placements), name
    rows = 10 + (-10) % model
    assert got["table"] == ((rows, 2), (rows // model, 2), True, (rows,))
    tree_a, tree_b0, b1_none, absent_none = got["tree"]
    np.testing.assert_array_equal(tree_a, x)
    np.testing.assert_array_equal(tree_b0, x[:2])
    assert b1_none and absent_none and got["padded"] == (12, 2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pad_rows_for_mesh(ranks, layout):
    rows, n = ranks["pad", layout]
    assert rows % (WORLD // LAYOUTS[layout]) == 0 and rows >= 10 and n == 10


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", FITS)
def test_mesh_fit_equals_single_device(ranks, name, layout):
    want, got = ranks["plain", name], ranks["fit", name, layout]
    assert want and set(got) == set(want)
    for attr in want:
        np.testing.assert_array_equal(got[attr], want[attr], err_msg=f"{name} {attr}")


def test_two_hosts_keep_model_groups_inside_a_host(ranks):
    hosts_of_groups, scores = ranks["two_hosts"]
    assert all(len(hosts) == 1 for hosts in hosts_of_groups)
    assert len(set.union(*hosts_of_groups)) == 2
    np.testing.assert_allclose(scores, ranks["two_hosts_plain"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_eval_matches_plain(ranks, layout):
    np.testing.assert_array_equal(ranks["eval", layout], ranks["eval", "plain"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_batch_eval_device_sharded(ranks, layout):
    got = ranks["batch_eval", layout]
    np.testing.assert_array_equal(got, ranks["batch_eval", "plain"])
    np.testing.assert_allclose(got, _jax_batch_eval(), rtol=1e-6)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tpu_exact_ann_sharded(ranks, layout, measure):
    (plain, sharded), rows_per_shard = ranks["ann", measure, layout]
    assert rows_per_shard >= 4  # the sharded path ran
    np.testing.assert_array_equal(sharded[0], plain[0])
    np.testing.assert_allclose(sharded[1], plain[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(sharded[0], _jax_ann_ids(measure))


def test_mesh_model_save_load_clone(ranks):
    saved = ranks["save"]
    assert saved["clone_shares"]  # clone shares the mesh, save drops it
    assert len(set(saved["paths"])) == 1  # rank 0 wrote; every rank has its path
    assert saved["loaded_mesh"] is None
    np.testing.assert_array_equal(saved["loaded_u"], saved["u"])
    assert saved["finite"]


@pytest.mark.parametrize("name", ["BPR", "MF"])
def test_mesh_fit_resumed_equals_uninterrupted(ranks, name):
    straight, resumed, steps = ranks["resume", name]
    assert steps == ["2", "3", "4"]  # two epochs, then resumed to four (max_to_keep 3)
    for attr in straight:
        np.testing.assert_array_equal(resumed[attr], straight[attr], err_msg=f"{name} {attr}")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
