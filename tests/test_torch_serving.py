"""The port's serving slice against the JAX package on the same inputs.

A small seeded dataset is built in both packages, a JAX ``BPR`` gets
seeded ``init_params``, and its fitted arrays are carried into the port
with ``bpr_from_arrays``. Both packages then answer the same questions:
scores (rtol 1e-5), recommendation lists (identical item IDs), exact
retrieval, server payloads, and ranking metrics (atol 1e-5, float32
counts on both sides).
"""

import json
import os
import threading
import urllib.request
import warnings
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset, Reader as JReader
from cornac_tpu.eval_methods import ranking_eval as j_ranking_eval
from cornac_tpu.metrics import AUC as JAUC, MAP as JMAP, NDCG as JNDCG
from cornac_tpu.metrics import Precision as JPrecision, Recall as JRecall
from cornac_tpu.models import BPR as JBPR, TPUExactANN as JANN
from cornac_tpu.serving import core as j_core
from cornac_tpu_torch.convert import bpr_from_arrays
from cornac_tpu_torch.data import Dataset, Reader
from cornac_tpu_torch.eval_methods import ranking_eval
from cornac_tpu_torch.metrics import AUC, MAP, NDCG, Precision, Recall
from cornac_tpu_torch.models import BPR, TPUExactANN
from cornac_tpu_torch.serving import core
from cornac_tpu_torch.serving.standalone import make_handler

cornac_tpu_torch.set_default_device("cpu")

N_USERS, N_ITEMS, K = 300, 200, 8


def _triples(rng, n):
    pairs = sorted({(rng.randint(N_USERS), rng.randint(N_ITEMS)) for _ in range(n)})
    rng.shuffle(pairs)
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(7)
    train_data = _triples(rng, 4000)
    train_pairs = {(u, i) for u, i, _ in train_data}
    test_data = [t for t in _triples(rng, 1500) if (t[0], t[1]) not in train_pairs]

    jtrain = JDataset.from_uir(train_data, seed=1)
    ptrain = Dataset.from_uir(train_data, seed=1)
    init = {
        "U": rng.uniform(-0.5, 0.5, (jtrain.num_users, K)).astype(np.float32),
        "V": rng.uniform(-0.5, 0.5, (jtrain.num_items, K)).astype(np.float32),
        "Bi": rng.uniform(-0.2, 0.2, jtrain.num_items).astype(np.float32),
    }
    jbpr = JBPR(k=K, trainable=False, init_params=init).fit(jtrain)
    arrays = {a: np.asarray(getattr(jbpr, a)) for a in ("u_factors", "i_factors", "i_biases")}
    meta = {
        m: getattr(jbpr, m)
        for m in ("k", "use_bias", "num_users", "num_items", "uid_map", "iid_map",
                  "min_rating", "max_rating", "global_mean")
    }
    pbpr = bpr_from_arrays(arrays, meta, device="cpu", train_set=ptrain)
    jann, pann = JANN(jbpr), TPUExactANN(pbpr)
    jann.build_index()
    pann.build_index()

    def test_set(cls, train):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return cls.build(test_data, global_uid_map=train.uid_map,
                             global_iid_map=train.iid_map, exclude_unknowns=True)

    return dict(
        jtrain=jtrain, ptrain=ptrain, jbpr=jbpr, pbpr=pbpr, jann=jann, pann=pann,
        jtest=test_set(JDataset, jtrain), ptest=test_set(Dataset, ptrain),
        test_data=test_data, uids=list(jtrain.uid_map)[:40],
    )


def test_datasets_identical(world):
    j, p = world["jtrain"], world["ptrain"]
    assert list(j.uid_map.items()) == list(p.uid_map.items())
    assert list(j.iid_map.items()) == list(p.iid_map.items())
    assert (j.csr_matrix != p.csr_matrix).nnz == 0
    for a, b in zip(j.uir_tuple, p.uir_tuple):
        np.testing.assert_array_equal(a, b)
    assert (j.num_ratings, j.global_mean) == (p.num_ratings, p.global_mean)


def test_carried_model(world):
    j, p = world["jbpr"], world["pbpr"]
    assert p.is_fitted and p.trainable is False
    assert (p.num_users, p.num_items, p.global_mean) == (j.num_users, j.num_items, j.global_mean)
    np.testing.assert_array_equal(p.get_user_vectors(), j.get_user_vectors())


def test_score_batch(world):
    users = np.arange(0, N_USERS, 7)
    np.testing.assert_allclose(
        world["pbpr"].score_batch(users), world["jbpr"].score_batch(users), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        world["pbpr"].score_batch_device(users).numpy(),
        np.asarray(world["jbpr"].score_batch_device(users)), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("remove_seen", [False, True])
@pytest.mark.parametrize("wrapper", ["bpr", "ann"])
def test_recommendations(world, wrapper, remove_seen):
    j, p = world["j" + wrapper], world["p" + wrapper]
    uids = world["uids"]
    jt, pt = world["jtrain"], world["ptrain"]
    for uid in uids[:10]:
        assert p.recommend(uid, k=5, remove_seen=remove_seen, train_set=pt) == j.recommend(
            uid, k=5, remove_seen=remove_seen, train_set=jt
        )
    assert p.recommend_batch(uids, k=5, remove_seen=remove_seen, train_set=pt) == (
        j.recommend_batch(uids, k=5, remove_seen=remove_seen, train_set=jt)
    )


def test_knn_query(world):
    q = world["jbpr"].get_user_vectors()[:25]
    for k in (5, N_ITEMS):
        ji, jd = world["jann"].knn_query(q, k)
        pi, pd = world["pann"].knn_query(q, k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wrapper", ["bpr", "ann"])
def test_handle_recommend(world, wrapper):
    j, p = world["j" + wrapper], world["p" + wrapper]
    for params in (
        {"uid": world["uids"][3], "k": "5"},
        {"uid": world["uids"][4], "k": "5", "remove_seen": "true"},
        {"uid": world["uids"][5]},
        {},
    ):
        assert core.handle_recommend(p, world["ptrain"], params) == j_core.handle_recommend(
            j, world["jtrain"], params
        )


def test_ranking_eval(world):
    jm = [JAUC(), JMAP(), JNDCG(k=10), JPrecision(k=10), JRecall(k=10)]
    pm = [AUC(), MAP(), NDCG(k=10), Precision(k=10), Recall(k=10)]
    javg, juser = j_ranking_eval(world["jbpr"], jm, world["jtrain"], world["jtest"])
    pavg, puser = ranking_eval(world["pbpr"], pm, world["ptrain"], world["ptest"])
    np.testing.assert_allclose(pavg, javg, atol=1e-5)
    for ju, pu in zip(juser, puser):
        assert ju.keys() == pu.keys()
        np.testing.assert_allclose([pu[u] for u in ju], list(ju.values()), atol=1e-5)


def test_handle_evaluate(world):
    query = {"metrics": ["RMSE()", "Recall(k=3)", "NDCG(k=10)", "AUC()"],
             "data": world["test_data"][:400]}
    payload, status = core.handle_evaluate(world["pbpr"], world["ptrain"], query)
    j_payload, j_status = j_core.handle_evaluate(world["jbpr"], world["jtrain"], query)
    assert status == j_status == 200
    assert payload["result"].keys() == j_payload["result"].keys()
    np.testing.assert_allclose(
        list(payload["result"].values()), list(j_payload["result"].values()), atol=1e-5
    )
    for name, users in j_payload["user_result"].items():
        assert payload["user_result"][name].keys() == users.keys()


@pytest.mark.parametrize("kwargs", [
    {},
    {"bin_threshold": 3.0, "min_user_freq": 2},
    {"num_top_freq_item": 40, "user_set": [f"u{u}" for u in range(0, N_USERS, 3)]},
])
def test_reader_matches_jax(world, tmp_path, kwargs):
    path = tmp_path / "uir.csv"
    path.write_text("".join(f"{u},{i},{r}\n" for u, i, r in world["test_data"]))
    want = JReader(**kwargs).read(str(path), fmt="UIR", sep=",")
    assert Reader(**kwargs).read(str(path), fmt="UIR", sep=",") == want and want


def test_handle_evaluate_from_feedback_log(world, tmp_path):
    # no "data" in the query: the handler reads the feedback CSV that
    # /feedback appends to
    log = str(tmp_path / "feedback.csv")
    for u, i, r in world["test_data"][:300]:
        core.handle_feedback({"uid": u, "iid": i, "rating": r}, data_fpath=log)
    query = {"metrics": ["RMSE()", "NDCG(k=10)"]}
    payload, status = core.handle_evaluate(world["pbpr"], world["ptrain"], query, data_fpath=log)
    j_payload, j_status = j_core.handle_evaluate(
        world["jbpr"], world["jtrain"], query, data_fpath=log
    )
    assert status == j_status == 200
    assert payload["result"].keys() == j_payload["result"].keys()
    np.testing.assert_allclose(
        list(payload["result"].values()), list(j_payload["result"].values()), atol=1e-5
    )


def test_metric_sandbox(world):
    # the port's metric classes live in cornac_tpu_torch.metrics.*: the
    # module-prefix filter must let them through and still refuse code
    assert {"RMSE", "Recall", "NDCG", "AUC"} <= set(core.ALLOWED_METRIC_NAMES)
    assert type(core.safe_eval_metric("RMSE()")).__name__ == "RMSE"
    assert core.safe_eval_metric("Recall(k=3)").k == 3
    payload, status = core.handle_evaluate(
        world["pbpr"], world["ptrain"],
        {"metrics": ["__import__('os')"], "data": world["test_data"][:10]},
    )
    assert status == 400


def test_trainer_not_ported(tmp_path):
    # the trainer itself is ported (tests/test_torch_bpr_train.py), and so
    # are checkpointing (tests/test_torch_checkpoint.py) and the mesh
    # (tests/test_torch_parallel.py), which takes a parallel.make_mesh mesh
    train = Dataset.from_uir([("u", "i", 1.0)])
    with pytest.raises(TypeError, match="DeviceMesh"):
        BPR(k=4, mesh=object())
    model = BPR(k=4, max_iter=1)
    assert model.enable_checkpointing(tmp_path / "ckpt", every=1) is model
    assert model.fit(train).u_factors.shape == (1, 4)
    assert os.listdir(tmp_path / "ckpt") == ["1"]


def test_standalone_server_roundtrip(world, tmp_path, monkeypatch):
    # save, load through MODEL_PATH/MODEL_CLASS, serve over HTTP, and get
    # the JAX package's answers back
    for wrapper, cls in (("ann", "TPUExactANN"), ("bpr", "BPR")):
        path = world["p" + wrapper].save(str(tmp_path / wrapper), save_trainset=True)
        monkeypatch.setenv("MODEL_PATH", path)
        monkeypatch.setenv("MODEL_CLASS", f"cornac_tpu_torch.models.{cls}")
        monkeypatch.chdir(tmp_path)
        model, train_set = core.load_model(".")
        assert type(model).__name__ == cls and train_set.num_ratings == world["ptrain"].num_ratings
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(model, train_set))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            uid = world["uids"][7]
            url = f"http://127.0.0.1:{server.server_address[1]}"
            with urllib.request.urlopen(f"{url}/recommend?uid={uid}&k=5&remove_seen=true") as r:
                body = json.loads(r.read())
            want, _ = j_core.handle_recommend(
                world["j" + wrapper], world["jtrain"],
                {"uid": uid, "k": "5", "remove_seen": "true"},
            )
            assert body == want
            req = urllib.request.Request(
                f"{url}/feedback?uid={uid}&iid=i3&rating=4", data=b"", method="POST"
            )
            with urllib.request.urlopen(req) as r:
                assert json.loads(r.read())["message"] == "Feedback added"
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()
    assert (tmp_path / "data" / "feedback.csv").read_text().count("\n") == 2


def test_device_factors_follow_the_numpy_factors(world):
    p = world["pbpr"]
    U, _, _ = p._device_factors()
    assert U.device == torch.device("cpu")
    assert p._device_factors()[0] is U  # cached
    clone = p.clone()
    assert clone.device == "cpu" and getattr(clone, "_factors_d", None) is None
