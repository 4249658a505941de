"""The quality bands of ``chip_smoke.py``'s trainers, from the JAX package.

Fits the JAX package's model on ``bench.make_ml100k_like(seed=7)`` split by
``RatioSplit(0.2, 4.0, seed=123)`` once per seed, on the CPU, and ranks the
test users as ``bench.py`` does (AUC, NDCG@10, Recall@10; RMSE and MAE for
the rating models). Prints one JSON line per seed, then one with the mean,
the spread (sample standard deviation) and the band of AUC and NDCG@10 (and
RMSE for the rating models) that ``chip_smoke.py`` holds the port's fit to:
``mean +/- 3 x spread``. The deterministic models (NMF, WMF, EASE, HPF, PF,
SKMeans, FM-als, SANSA: no sampling, the same fit on every run from one
seed) are fitted once, with the first seed, and their band is
``value +/- DETERMINISTIC_TOL``. ``tools/quality_bands.py`` keeps the
bands it printed, which ``chip_smoke.py`` reads.

``--model`` picks the configuration (``benchmarks/model_sweep.py``'s, or
the ones named below): ``BPR`` (``bench.py``'s, the default), ``PMF``,
``MF-adam`` (adam with embedding dropout 0.1), ``IBPR``, ``COE``, ``NMF``,
``WMF``, ``EASE``, and the neural family's ``VAECF``, ``RecVAE``, ``BiVAECF``,
``NeuMF``, ``LightGCN``, with ``GMF`` and ``MLP`` at NeuMF's depth and ``NGCF``
at LightGCN's, and the factor family's rest: ``HPF``, ``PF`` (HPF with
``hierarchical=False``), ``SKMeans``, ``FM-als`` (``model_sweep.py``'s),
``FM-sgd`` and ``FM-mcmc`` (``examples/fm_example.py``'s settings) and
``SANSA`` (``examples/sansa_movielens.py``'s). The models that read a
modality are fitted on ``tests/golden_models.py``'s block data instead
(``golden_split``), at its builders' settings, and ranked by its train AUC
(in-block discrimination, ``golden_models.train_auc``): ``SBPR`` (with the
user graph), ``VEBPR`` (purchases and views), and ``C2PF``, ``TC2PF`` and
``RC2PF`` (with the item graph; deterministic). The next-item models
``SPop`` (deterministic), ``FPMC`` (``examples/fpmc_diginetica.py``'s),
``GRU4Rec`` and ``SASRec`` (``benchmarks/head_to_head_seq.py``'s
``GRU_KW``/``SAS_KW``) are fitted on ``seq_bench_data.gen_sessions``'
sessions under ``NextItemEvaluation.from_splits(mode="next")`` and banded
on MRR, HitRatio@20 and NDCG@20; ``CVAECF``
(``examples/cvaecf_filmtrust.py``'s, with ``seq_bench_data.seeded_trust``
as its user graph, ``RatioSplit(0.2, 3.0)``) on NDCG@50 and Recall@50, and
``GCMC`` (``examples/gcmc_example.py``'s, ``RatioSplit(0.2)``) on RMSE,
both on ``make_ml100k_like(7)``; their bands come from ten seeds, 123-132
(five seeds misjudged GRU4Rec's MRR spread by a factor of two: 0.00054 over
123-127, 0.00097 over 128-132). ``--package torch`` fits the port instead, on the CPU,
to see where its fits fall. ``--bf16-products`` rounds both operands of
every float32 matrix product of the JAX package to bfloat16 and sums in
float32: one bf16 pass, what a TPU's matrix unit does at JAX's default
precision, which the CPU ignores (it computes such products in float32
whatever the precision asked for).

    python tools/bpr_quality_band.py [--model BPR] [--seeds 123 124 125 126 127]
                                     [--package torch] [--bf16-products]
"""

import argparse
import json
import os
import sys

import numpy as np

from quality_bands import DETERMINISTIC_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def one_bf16_pass():
    """Round the float32 operands of every JAX matrix product to bfloat16
    (the products themselves still sum in float32). ``jnp.matmul``,
    ``jnp.tensordot`` and ``@`` all reach ``lax.dot_general`` through the
    module attribute patched here."""
    import jax.numpy as jnp
    from jax._src.lax import lax

    dot_general = lax.dot_general

    def rounded(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32) if x.dtype == jnp.float32 else x

    def bf16_dot_general(lhs, rhs, *args, **kwargs):
        return dot_general(rounded(lhs), rounded(rhs), *args, **kwargs)

    lax.dot_general = bf16_dot_general


# name -> (class name, constructor arguments without the seed, seeded,
# rating model)
CONFIGS = {
    "BPR": ("BPR", dict(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01,
                        batch_size=4096), True, False),
    "PMF": ("PMF", dict(k=10, max_iter=100), True, True),
    "MF-adam": ("MF", dict(k=10, max_iter=20, optimizer="adam", dropout=0.1), True, True),
    "IBPR": ("IBPR", dict(k=10, max_iter=20), True, False),
    "COE": ("COE", dict(k=10, max_iter=20), True, False),
    "NMF": ("NMF", dict(k=15, max_iter=50), False, True),
    "WMF": ("WMF", dict(k=50, max_iter=30, verbose=False), False, False),
    "EASE": ("EASE", dict(lamb=500, verbose=False), None, False),
    "VAECF": ("VAECF", dict(k=10, n_epochs=100), True, False),
    "RecVAE": ("RecVAE", dict(n_epochs=20, verbose=False), True, False),
    "BiVAECF": ("BiVAECF", dict(k=10, n_epochs=100), True, False),
    "GMF": ("GMF", dict(num_factors=8, num_epochs=10, verbose=False), True, False),
    "MLP": ("MLP", dict(layers=(32, 16, 8), num_epochs=10, verbose=False), True, False),
    "NeuMF": ("NeuMF", dict(num_factors=8, layers=(32, 16, 8), num_epochs=10, verbose=False),
              True, False),
    "LightGCN": ("LightGCN", dict(emb_size=64, num_layers=3, num_epochs=40), True, False),
    "NGCF": ("NGCF", dict(emb_size=64, num_epochs=40), True, False),
    "HPF": ("HPF", dict(k=5, max_iter=100), False, False),
    "PF": ("HPF", dict(k=5, max_iter=100, hierarchical=False), False, False),
    "SKMeans": ("SKMeans", dict(k=5, max_iter=100, verbose=False), False, False),
    "FM-als": ("FM", dict(k2=8, max_iter=50, method="als", verbose=False), False, True),
    "FM-sgd": ("FM", dict(k0=1, k1=1, k2=8, max_iter=100, learning_rate=0.01, method="sgd",
                          verbose=False), True, True),
    "FM-mcmc": ("FM", dict(k0=1, k1=1, k2=8, max_iter=100, learning_rate=0.01, method="mcmc",
                           verbose=False), True, True),
    "SANSA": ("SANSA", dict(l2=500.0, weight_matrix_density=0.01, verbose=False), None, False),
}

# name -> (class name, constructor arguments without the seed, seeded,
# golden_models split): tests/golden_models.py's builders
GOLDEN_CONFIGS = {
    "SBPR": ("SBPR", dict(k=8, max_iter=80, learning_rate=0.05, batch_size=256), True,
             "user_graph"),
    "VEBPR": ("VEBPR", dict(k=8, max_iter=80, learning_rate=0.05, batch_size=256), True,
              "purchase_view"),
    "C2PF": ("C2PF", dict(k=8, max_iter=40, variant="c2pf"), False, "item_graph"),
    "TC2PF": ("C2PF", dict(k=8, max_iter=40, variant="tc2pf"), False, "item_graph"),
    "RC2PF": ("C2PF", dict(k=8, max_iter=40, variant="rc2pf"), False, "item_graph"),
}


# name -> (class name, constructor arguments without the seed, seeded)
SEQ_CONFIGS = {
    "SPop": ("SPop", {}, None),
    "FPMC": ("FPMC", dict(embedding_dim=32, n_epochs=10, learning_rate=0.01, batch_size=1024),
             True),
    "GRU4Rec": ("GRU4Rec", dict(layers=[64], loss="cross-entropy", batch_size=64,
                                learning_rate=0.05, n_epochs=5, n_sample=128), True),
    "SASRec": ("SASRec", dict(embedding_dim=64, loss="ce", batch_size=64, learning_rate=0.001,
                              n_epochs=5, max_len=20, num_blocks=2, num_heads=1, n_sample=128),
               True),
}
SEQ_METRICS = ("MRR", "HitRatio@20", "NDCG@20")

# name -> (class name, constructor arguments without the seed, metrics)
AUX_CONFIGS = {
    "CVAECF": ("CVAECF", dict(z_dim=20, h_dim=20, autoencoder_structure=[40],
                              learning_rate=0.001, n_epochs=70), ("NDCG@50", "Recall@50")),
    "GCMC": ("GCMC", dict(max_iter=1000, learning_rate=0.01, train_early_stopping_patience=100),
             ("RMSE",)),
}


def seq_eval(eval_methods, metrics, seed=123):
    """The next-item cell: ``gen_sessions``' split under
    ``NextItemEvaluation`` (mode 'next', unknown items excluded), and its
    three metrics."""
    from seq_bench_data import gen_sessions, session_split

    train, test = session_split(gen_sessions())
    ev = eval_methods.NextItemEvaluation.from_splits(
        train_data=train, test_data=test, fmt="USIT", exclude_unknowns=True, seed=seed,
        mode="next")
    return ev, [metrics.MRR(), metrics.HitRatio(k=20), metrics.NDCG(k=20)]


def aux_split(name, data, eval_methods, triples):
    """CVAECF's split (with the seeded user graph) or GCMC's, of
    ``triples``."""
    if name == "CVAECF":
        from seq_bench_data import seeded_trust

        return eval_methods.RatioSplit(
            data=triples, test_size=0.2, rating_threshold=3.0, exclude_unknowns=True, seed=123,
            user_graph=data.GraphModality(data=seeded_trust(triples)))
    return eval_methods.RatioSplit(data=triples, test_size=0.2, exclude_unknowns=True, seed=123)


def aux_metrics(name, metrics):
    if name == "CVAECF":
        return [metrics.NDCG(k=50), metrics.Recall(k=50)]
    return [metrics.RMSE()]


def band_summary(runs, names):
    """{metric: {"mean", "spread", "band"}} over the runs (a single run:
    the value +/- DETERMINISTIC_TOL)."""
    out = {}
    for name in names:
        values = np.asarray([run[name] for run in runs])
        mean = float(values.mean())
        spread = float(values.std(ddof=1)) if len(values) > 1 else None
        half = 3 * spread if spread is not None else DETERMINISTIC_TOL
        out[name] = {"mean": mean, "spread": spread, "band": [mean - half, mean + half]}
    return out


def golden_split(kind, data, eval_methods):
    """``tests/golden_models.py``'s split ``kind`` ("user_graph",
    "item_graph" or "purchase_view") built with a package's ``data`` and
    ``eval_methods`` modules (the JAX package's or the port's): a RatioSplit
    of the block data with the graph modality, or, for "purchase_view", an
    object whose ``train_set`` is the PurchaseViewDataset of purchases and
    views."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden_models as g

    if kind == "purchase_view":
        class Split:
            train_set = data.PurchaseViewDataset.build(
                g.implicit_data(seed=3), g.implicit_data(seed=4, n=800), seed=g.SEED)
            test_set = None
        return Split()
    graph = {"user_graph": g.user_graph, "item_graph": g.item_graph}[kind]()
    return eval_methods.RatioSplit(data=g.implicit_data(), test_size=0.2, rating_threshold=1.0,
                                   seed=g.SEED, **{kind: data.GraphModality(data=graph)})


def golden_auc(model, train_set):
    """``golden_models.train_auc``: the in-block discrimination of a fit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden_models as g

    return g.train_auc(model, train_set)


def make_model(models, name, seed):
    """The configuration ``name`` of the package ``models`` with ``seed``
    (EASE takes none)."""
    table = next(t for t in (CONFIGS, GOLDEN_CONFIGS, SEQ_CONFIGS, AUX_CONFIGS) if name in t)
    cls, kwargs, seeded = table[name][:3]
    if table is AUX_CONFIGS:
        seeded = True
    if seeded is not None:
        kwargs = {**kwargs, "seed": seed}
    return getattr(models, cls)(**kwargs)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(CONFIGS) + sorted(GOLDEN_CONFIGS)
                        + sorted(SEQ_CONFIGS) + sorted(AUX_CONFIGS),
                        default="BPR")
    parser.add_argument("--seeds", type=int, nargs="+", default=None,
                        help="default: 123-127; 123-132 for the next-item models, CVAECF and "
                             "GCMC")
    parser.add_argument("--package", choices=("jax", "torch"), default="jax")
    parser.add_argument("--bf16-products", action="store_true",
                        help="JAX package only: every float32 matrix product in one bf16 pass")
    args = parser.parse_args()
    if args.bf16_products and args.package != "jax":
        parser.error("--bf16-products applies to the JAX package")

    if args.seeds is None:
        wide = args.model in SEQ_CONFIGS or args.model in AUX_CONFIGS
        args.seeds = list(range(123, 133 if wide else 128))

    import bench

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.bf16_products:
            one_bf16_pass()
        from cornac_tpu import data, eval_methods, metrics, models
        from cornac_tpu.eval_methods import RatioSplit
        from cornac_tpu.eval_methods.base_method import ranking_eval, rating_eval
        from cornac_tpu.metrics import AUC, MAE, NDCG, RMSE, Recall
    else:
        import cornac_tpu_torch

        cornac_tpu_torch.set_default_device("cpu")
        from cornac_tpu_torch import data, eval_methods, metrics, models
        from cornac_tpu_torch.eval_methods import RatioSplit
        from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
        from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall

    summary = {"model": args.model, "package": args.package, "device": "cpu",
               "bf16_products": args.bf16_products}
    if args.model in GOLDEN_CONFIGS:
        seeded, kind = GOLDEN_CONFIGS[args.model][2:]
        split = golden_split(kind, data, eval_methods)
        seeds = args.seeds if seeded else args.seeds[:1]
        values = []
        for seed in seeds:
            model = make_model(models, args.model, seed).fit(split.train_set)
            values.append(golden_auc(model, split.train_set))
            print(json.dumps({"model": args.model, "seed": seed, "AUC": values[-1]}), flush=True)
        values = np.asarray(values)
        mean = float(values.mean())
        spread = float(values.std(ddof=1)) if len(values) > 1 else None
        half = 3 * spread if spread is not None else DETERMINISTIC_TOL
        summary.update(seeds=seeds, AUC={"mean": mean, "spread": spread,
                                         "band": [mean - half, mean + half]})
        print(json.dumps(summary))
        return

    if args.model in SEQ_CONFIGS:
        ev, seq_metrics = seq_eval(eval_methods, metrics)
        seeds = args.seeds if SEQ_CONFIGS[args.model][2] else args.seeds[:1]
        runs = []
        for seed in seeds:
            result = ev.evaluate(make_model(models, args.model, seed), seq_metrics,
                                 user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in SEQ_METRICS})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=seeds, **band_summary(runs, SEQ_METRICS))
        print(json.dumps(summary))
        return
    if args.model in AUX_CONFIGS:
        names = AUX_CONFIGS[args.model][2]
        split = aux_split(args.model, data, eval_methods, bench.make_ml100k_like())
        runs = []
        for seed in args.seeds:
            result = split.evaluate(make_model(models, args.model, seed),
                                    aux_metrics(args.model, metrics), user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in names})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=args.seeds, **band_summary(runs, names))
        print(json.dumps(summary))
        return

    rs = RatioSplit(data=bench.make_ml100k_like(), test_size=0.2, rating_threshold=4.0,
                    seed=123, verbose=False)
    seeded, rating = CONFIGS[args.model][2:]
    seeds = args.seeds if seeded else args.seeds[:1]
    runs = []
    for seed in seeds:
        model = make_model(models, args.model, seed).fit(rs.train_set)
        ranking, _ = ranking_eval(model, [AUC(), NDCG(k=10), Recall(k=10)], rs.train_set,
                                  rs.test_set, rating_threshold=4.0, exclude_unknowns=True)
        row = dict(zip(("AUC", "NDCG@10", "Recall@10"), map(float, ranking)))
        if rating:
            errors, _ = rating_eval(model, [RMSE(), MAE()], rs.test_set)
            row.update(zip(("RMSE", "MAE"), map(float, errors)))
        runs.append(row)
        print(json.dumps({"model": args.model, "seed": seed, **row}), flush=True)
    summary["seeds"] = seeds
    for name in ("AUC", "NDCG@10") + (("RMSE",) if rating else ()):
        values = np.asarray([run[name] for run in runs])
        mean = float(values.mean())
        spread = float(values.std(ddof=1)) if len(values) > 1 else None
        half = 3 * spread if spread is not None else DETERMINISTIC_TOL
        summary[name] = {"mean": mean, "spread": spread, "band": [mean - half, mean + half]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
