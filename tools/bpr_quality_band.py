"""The quality band of ``bench.py``'s BPR configuration, from the JAX package.

Fits the JAX package's ``BPR(k=10, max_iter=200, learning_rate=0.001,
lambda_reg=0.01, batch_size=4096)`` on ``bench.make_ml100k_like(seed=7)``
split by ``RatioSplit(0.2, 4.0, seed=123)`` once per BPR seed, on the CPU,
and ranks the test users as ``bench.py`` does. Prints one JSON line per
seed, then one with the mean, the spread (sample standard deviation) and
the band ``mean +/- 3 x spread`` of AUC and NDCG@10, the band that
``chip_smoke.py`` holds the port's fit to. ``--package torch`` fits the
port instead, on the CPU, to see where its fits fall. ``--bf16-products``
rounds both operands of every float32 matrix product of the JAX package to
bfloat16 and sums in float32: one bf16 pass, what a TPU's matrix unit does
at JAX's default precision, which the CPU ignores (it computes such
products in float32 whatever the precision asked for).

    python tools/bpr_quality_band.py [--seeds 123 124 125 126 127] [--package torch]
                                     [--bf16-products]
"""

import argparse
import json
import os
import sys

import numpy as np

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
        from cornac_tpu.eval_methods import RatioSplit
        from cornac_tpu.eval_methods.base_method import ranking_eval
        from cornac_tpu.metrics import AUC, NDCG
        from cornac_tpu.models import BPR
    else:
        import cornac_tpu_torch

        cornac_tpu_torch.set_default_device("cpu")
        from cornac_tpu_torch.eval_methods import RatioSplit
        from cornac_tpu_torch.eval_methods.base_method import ranking_eval
        from cornac_tpu_torch.metrics import AUC, NDCG
        from cornac_tpu_torch.models import BPR

    rs = RatioSplit(data=bench.make_ml100k_like(), test_size=0.2, rating_threshold=4.0,
                    seed=123, verbose=False)
    runs = []
    for seed in args.seeds:
        model = BPR(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01, seed=seed,
                    batch_size=4096).fit(rs.train_set)
        (auc, ndcg), _ = ranking_eval(model, [AUC(), NDCG(k=10)], rs.train_set, rs.test_set,
                                      rating_threshold=4.0, exclude_unknowns=True)
        runs.append((float(auc), float(ndcg)))
        print(json.dumps({"seed": seed, "AUC": runs[-1][0], "NDCG@10": runs[-1][1]}), flush=True)
    summary = {"package": args.package, "device": "cpu", "seeds": args.seeds,
               "bf16_products": args.bf16_products}
    for name, values in zip(("AUC", "NDCG@10"), np.asarray(runs).T):
        mean, spread = float(values.mean()), float(values.std(ddof=1))
        summary[name] = {"mean": mean, "spread": spread,
                         "band": [mean - 3 * spread, mean + 3 * spread]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
