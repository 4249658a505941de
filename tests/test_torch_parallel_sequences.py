"""The ``mesh=`` branches of the port's next-item, generative and next-basket
models (ROADMAP A8 (c)) on a group of four gloo ranks on the CPU, against
the port's single-device fits, which the parity files hold against the JAX
package (``tests/test_torch_sequential.py``, ``test_torch_transformer_rec.py``,
``test_torch_tiger.py``, ``test_torch_next_basket.py``).

The module-scoped fixture ``ranks`` starts this file as four ranks
(``tests/gloo_ranks.py``). The ranks share out the single-device fits;
then every rank fits each case on the (data, model) layouts (4, 1), (2, 2)
and (1, 4), and rank 0 writes the results. The cases mirror
``tests/test_parallel.py:632-753`` and ``:1191-1226`` (the JAX package's,
a slow file), with minibatches of 256 rows and more, so that every rank
holds rows of each (a data slice is a multiple of 64 rows,
``parallel.sharded.SLICE_ROWS``), and DNNTSP under ``optimizer="sgd"``, as
that JAX test runs it:

- FPMC (the general path, the plain fit with ``fused_path`` False), GRU4Rec
  and SASRec with dropout, TransformerRec (clm), BERT4Rec with dropout,
  TIGER's seq2seq (residual k-means), Beacon and DNNTSP: the scores of the
  mesh fit (sharded where the model shards its scoring) against the
  single-device fit's at the JAX test's rtol 2e-4 / atol 2e-5;
- SASRec and Beacon on minibatches of fewer than 64 rows, which rank 0
  holds whole while the other ranks hold none: the single-device fit's
  bits, the empty ranks adding zeros;
- every case and layout: every rank's parameters and scores equal to rank
  0's bit for bit, the replicas of one model;
- ``score_history_batch`` / ``score_baskets_batch`` of a mesh-fitted model,
  its histories split over the ranks, against the same model's unsharded
  scores at rtol 1e-5 / atol 1e-6;
- ``NextItemEvaluation(mesh=)`` and ``NextBasketEvaluation(mesh=)``: the
  plain evaluation's metrics, the protocols themselves unsharded.
"""

import copy
import os
import sys

import numpy as np
import pytest

from gloo_ranks import LAYOUTS, gather_shares, join_group, spawn_ranks, write_results

SEQ = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py:632-753, :1191-1226
SHARDED = dict(rtol=1e-5, atol=1e-6)  # the split scoring against the whole batch's

# name: (data, class, constructor arguments, held)
CASES = {
    "FPMC": ("sessions", "FPMC", dict(embedding_dim=8, n_epochs=3, batch_size=512, n_sample=8,
                                      seed=7), SEQ),
    "GRU4Rec": ("sessions", "GRU4Rec", dict(layers=[8], n_epochs=3, batch_size=1024, n_sample=8,
                                            dropout_p_embed=0.1, dropout_p_hidden=0.1, seed=7),
                SEQ),
    "SASRec": ("sessions", "SASRec", dict(embedding_dim=8, n_epochs=3, batch_size=1024,
                                          n_sample=8, max_len=10, seed=7), SEQ),
    "TransformerRec": ("sessions", "TransformerRec", dict(
        backbone="gpt2", objective="clm", embedding_dim=8, n_epochs=3, batch_size=256,
        n_sample=8, max_len=10, dropout=0.0, seed=7), SEQ),
    "BERT4Rec": ("sessions", "BERT4Rec", dict(embedding_dim=8, n_epochs=3, batch_size=256,
                                              n_sample=8, max_len=10, dropout=0.1, seed=7), SEQ),
    "TIGER": ("sessions", "TIGER", dict(
        tokenizer="rkmeans", rqvae_num_levels=2, rqvae_codebook_size=8, d_model=8, d_ff=16,
        num_heads=2, d_kv=4, num_enc_layers=1, num_dec_layers=1, dropout=0.0, max_len=6,
        n_epochs=2, batch_size=512, n_beams=4, seed=7), SEQ),
    "Beacon": ("baskets", "Beacon", dict(emb_dim=4, rnn_unit=4, n_epochs=2, batch_size=256,
                                         seed=7), SEQ),
    "DNNTSP": ("baskets", "DNNTSP", dict(emb_dim=8, n_epochs=2, batch_size=256, seed=7,
                                         optimizer="sgd"), SEQ),
    # under 64 rows a minibatch: rank 0 holds every row, the others none
    "SASRec-few": ("sessions", "SASRec", dict(embedding_dim=8, n_epochs=2, batch_size=160,
                                              n_sample=8, max_len=10, seed=7), "bits"),
    "Beacon-few": ("baskets", "Beacon", dict(emb_dim=4, rnn_unit=4, n_epochs=2, batch_size=48,
                                             seed=7), "bits"),
}
# the classes whose scoring splits the histories over a mesh, as the JAX
# package's shards them (FPMC's and TIGER's do not)
SHARDED_SCORING = ("GRU4Rec", "SASRec", "TransformerRec", "BERT4Rec", "Beacon", "DNNTSP",
                   "SASRec-few", "Beacon-few")
EVALUATED = {"item": "SASRec-few", "basket": "Beacon-few"}
N_SESSIONS = 600
N_USERS = 300


def _sessions(pkg):
    """(train sessions with item features, test sessions) as SIT rows built
    by ``pkg``'s ``data`` module: 3 to 7 items of 60 a session."""
    rng = np.random.RandomState(5)
    rows = [(f"s{s}", f"i{rng.randint(60)}", t) for s in range(N_SESSIONS)
            for t in range(rng.randint(3, 8))]
    ds = pkg.SequentialDataset.build(rows)
    feats = rng.rand(ds.num_items, 12).astype(np.float32)
    fm = pkg.FeatureModality(features=feats, ids=list(ds.iid_map.keys()), normalized=False)
    fm.build(id_map=ds.iid_map)
    ds.item_feature = fm
    return ds, rows


def _baskets():
    """UBI rows: 300 users, 3 to 5 baskets each of 1 to 3 items of 20."""
    rng = np.random.RandomState(6)
    rows = []
    for u in range(N_USERS):
        for b in range(rng.randint(3, 6)):
            for i in rng.choice(20, size=rng.randint(1, 4), replace=False):
                rows.append((f"u{u}", f"b{u * 10 + b}", f"i{i}"))
    return rows


def _histories(kind):
    """256 scored histories: item lists, or basket lists."""
    rng = np.random.RandomState(9)
    if kind == "sessions":
        return [list(rng.randint(0, 50, size=rng.randint(1, 6))) for _ in range(256)]
    return [[list(rng.choice(20, size=rng.randint(1, 4), replace=False))
             for _ in range(rng.randint(1, 4))] for _ in range(256)]


def _scores(model, kind):
    hs = _histories(kind)
    users = np.zeros(len(hs), int)
    if kind == "sessions":
        return model.score_history_batch(users, hs)
    return model.score_baskets_batch(users, hs)


def _params(model):
    """{name: numpy array} of a fitted model's parameters."""
    import torch

    params = model.params
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {n: p.detach().cpu().numpy() for n, p in params.items()}


def _fit_case(name, mesh, data):
    """The case's fit with ``mesh`` (or none): (scores, {parameters and
    scores} of this rank's replica, its unsharded scores or None)."""
    import cornac_tpu_torch.models as P

    kind, cls, kw, _ = CASES[name]
    model = getattr(P, cls)(mesh=mesh, **kw)
    if cls == "FPMC":
        model.fused_path = False  # the plain fit on the mesh's path, as the JAX test sets it
    model.fit(data[kind])
    scores = _scores(model, kind)
    assert np.isfinite(scores).all(), name
    if mesh is None:
        return scores
    whole = None
    if name in SHARDED_SCORING:
        alone = copy.copy(model)
        alone.mesh = None
        whole = _scores(alone, kind)
    return scores, dict(_params(model), scores=scores), whole


def _evaluations(mesh, data):
    """{kind: the metrics' averages} of ``EVALUATED``'s models through the
    two protocols, with ``mesh`` (or none)."""
    import cornac_tpu_torch.models as P
    from cornac_tpu_torch import eval_methods as E, metrics as Mt

    out = {}
    for kind, name in EVALUATED.items():
        _, cls, kw, _ = CASES[name]
        model = getattr(P, cls)(mesh=mesh, **kw)
        if kind == "item":
            ev = E.NextItemEvaluation.from_splits(data["train_rows"], data["test_rows"],
                                                  fmt="SIT", seed=3, mesh=mesh)
            metrics = [Mt.Recall(k=10), Mt.NDCG(k=10), Mt.MRR()]
        else:
            ev = E.NextBasketEvaluation(data=data["basket_rows"], test_size=0.2, seed=3,
                                        mesh=mesh)
            metrics = [Mt.Recall(k=5), Mt.NDCG(k=5)]
        assert ev.mesh is mesh
        result, _ = ev.evaluate(model, metrics, user_based=False)
        out[kind] = {k: v for k, v in result.metric_avg_results.items() if "(s)" not in k}
    return out


def _rank_main(rank, port, outdir):
    import torch.distributed as dist

    join_group(rank, port)
    from cornac_tpu_torch import data as pdata
    from cornac_tpu_torch.parallel import make_mesh

    sessions, rows = _sessions(pdata)
    cut = N_SESSIONS * 4 // 5  # the evaluation's train and test sessions
    data = {"sessions": sessions, "baskets": pdata.BasketDataset.build(_baskets()),
            "basket_rows": _baskets(),
            "train_rows": [r for r in rows if int(r[0][1:]) < cut],
            "test_rows": [r for r in rows if int(r[0][1:]) >= cut]}
    names = list(CASES)
    plain = {("plain", n): _fit_case(n, None, data) for n in names[rank::dist.get_world_size()]}
    if rank == 0:
        plain["eval", "plain"] = _evaluations(None, data)
    out = gather_shares(plain)
    replicas = {}
    for layout, dp in LAYOUTS.items():
        mesh = make_mesh(data_parallel=dp)
        for name in names:
            got, replicas[name, layout], out["whole", name, layout] = _fit_case(name, mesh, data)
            out["fit", name, layout] = got
        if layout == "2x2":
            out["eval", "mesh"] = _evaluations(mesh, data)
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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_fit_equals_single_device(ranks, name, layout):
    want, got = ranks["plain", name], ranks["fit", name, layout]
    held = CASES[name][3]
    assert got.shape == want.shape and np.isfinite(got).all()
    if held == "bits":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **held)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_fit_replicas_agree(ranks, name, layout):
    first, *rest = (r[name, layout] for r in ranks["replicas"])
    assert len(first) > 1
    for rank, theirs in enumerate(rest, 1):
        assert set(theirs) == set(first)
        for key, want in first.items():
            np.testing.assert_array_equal(theirs[key], want, err_msg=f"{name} rank {rank} {key}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SHARDED_SCORING)
def test_sharded_scores_equal_the_whole_batchs(ranks, name, layout):
    got, whole = ranks["fit", name, layout], ranks["whole", name, layout]
    assert whole is not None and got.shape == whole.shape
    np.testing.assert_allclose(got, whole, err_msg=name, **SHARDED)


@pytest.mark.parametrize("kind", EVALUATED)
def test_evaluation_with_mesh_gives_the_plain_metrics(ranks, kind):
    want, got = ranks["eval", "plain"][kind], ranks["eval", "mesh"][kind]
    assert want and set(got) == set(want)
    for metric, value in want.items():
        np.testing.assert_allclose(got[metric], value, rtol=1e-6, atol=1e-9, err_msg=metric)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
