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
``SANSA`` (``examples/sansa_movielens.py``'s). ``--package torch`` fits the port instead, on the CPU,
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


def make_model(models, name, seed):
    """The configuration ``name`` of the package ``models`` with ``seed``
    (EASE takes none)."""
    cls, kwargs, seeded, _ = CONFIGS[name]
    if seeded is not None:
        kwargs = {**kwargs, "seed": seed}
    return getattr(models, cls)(**kwargs)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(CONFIGS), default="BPR")
    parser.add_argument("--seeds", type=int, nargs="+", default=[123, 124, 125, 126, 127])
    parser.add_argument("--package", choices=("jax", "torch"), default="jax")
    parser.add_argument("--bf16-products", action="store_true",
                        help="JAX package only: every float32 matrix product in one bf16 pass")
    args = parser.parse_args()
    if args.bf16_products and args.package != "jax":
        parser.error("--bf16-products applies to the JAX package")

    import bench

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.bf16_products:
            one_bf16_pass()
        from cornac_tpu import models
        from cornac_tpu.eval_methods import RatioSplit
        from cornac_tpu.eval_methods.base_method import ranking_eval, rating_eval
        from cornac_tpu.metrics import AUC, MAE, NDCG, RMSE, Recall
    else:
        import cornac_tpu_torch

        cornac_tpu_torch.set_default_device("cpu")
        from cornac_tpu_torch import models
        from cornac_tpu_torch.eval_methods import RatioSplit
        from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
        from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall

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
    summary = {"model": args.model, "package": args.package, "device": "cpu", "seeds": seeds,
               "bf16_products": args.bf16_products}
    for name in ("AUC", "NDCG@10") + (("RMSE",) if rating else ()):
        values = np.asarray([run[name] for run in runs])
        mean = float(values.mean())
        spread = float(values.std(ddof=1)) if len(values) > 1 else None
        half = 3 * spread if spread is not None else DETERMINISTIC_TOL
        summary[name] = {"mean": mean, "spread": spread, "band": [mean - half, mean + half]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
