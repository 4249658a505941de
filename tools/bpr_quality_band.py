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
on MRR, HitRatio@20 and NDCG@20, as are the generative models of
``GENERATIVE_CONFIGS`` (``BERT4Rec``, ``TransformerRec-clm``,
``TransformerRec-clm-last``, ``TransformerRec-plm``, ``TransformerRec-rtd``,
``TIGER-rqvae`` with beam scoring and ``TIGER-rkmeans`` with exact scoring,
TIGER over ``seq_bench_data.session_features``); ``CVAECF``
(``examples/cvaecf_filmtrust.py``'s, with ``seq_bench_data.seeded_trust``
as its user graph, ``RatioSplit(0.2, 3.0)``) on NDCG@50 and Recall@50, and
``GCMC`` (``examples/gcmc_example.py``'s, ``RatioSplit(0.2)``) on RMSE,
both on ``make_ml100k_like(7)``, and the next-basket models ``Beacon``
and ``DNNTSP`` (``examples/beacon_tafeng.py``'s and
``examples/dnntsp_tafeng.py``'s settings) on ``seq_bench_data.gen_baskets``'
baskets under ``NextBasketEvaluation(test_size=0.2, seed=123)`` on
Recall@10, Recall@50 and HitRatio@10, and the side-information models of
``SIDE_CONFIGS`` (``SoRec``, ``MCF``, ``VBPR``, ``AMR``, ``CausalRec``,
``VMF``, ``DMRL``, ``PCRL``) on ``make_ml100k_like(7)`` with
``seq_bench_data.side_modalities`` (``side_split``) on AUC, NDCG@10 and
Recall@10, and the text and review models of ``TEXT_CONFIGS`` (``NARRE``,
``HRDR``, ``CDL``, ``CDR``, ``CVAE``, ``ConvMF``, ``CTR``, ``HFT``) on
``make_ml100k_like(7)`` with ``seq_bench_data.text_modalities``
(``text_split``) on AUC, NDCG@10 and Recall@10 (NARRE and HRDR also on
RMSE over the test ratings); their bands come from ten seeds, 123-132
(five seeds misjudged GRU4Rec's MRR spread by a factor of two: 0.00054 over
123-127, 0.00097 over 128-132). ``--package torch`` fits the port instead, on the CPU,
to see where its fits fall (``--device cuda``: on the card, whose random
streams are not the CPU's). ``--bf16-products`` rounds both operands of
every float32 matrix product of the JAX package to bfloat16 and sums in
float32: one bf16 pass, what a TPU's matrix unit does at JAX's default
precision, which the CPU ignores (it computes such products in float32
whatever the precision asked for).

    python tools/bpr_quality_band.py [--model BPR] [--seeds 123 124 125 126 127]
                                     [--package torch [--device cuda]] [--bf16-products]
"""

import argparse
import functools
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

# the generative next-item models on the same sessions, narrow (d 64, two
# blocks of two heads, max_len 20; TIGER: two levels of 16 codes over
# seq_bench_data.session_features, one encoder and one decoder block):
# name -> (class name, constructor arguments without the seed, seeded)
_TRANSFORMER = dict(embedding_dim=64, num_blocks=2, num_heads=2, max_len=20, batch_size=64,
                    learning_rate=0.005, n_epochs=10, n_sample=128)
_TIGER = dict(rqvae_latent_dim=16, rqvae_hidden_dims=(64,), rqvae_num_levels=2,
              rqvae_codebook_size=16, rqvae_n_epochs=50, rqvae_batch_size=256, d_model=32,
              d_ff=64, num_heads=2, d_kv=16, num_enc_layers=1, num_dec_layers=1, max_len=10,
              n_epochs=5, batch_size=128, learning_rate=0.003, n_beams=20)
GENERATIVE_CONFIGS = {
    "BERT4Rec": ("BERT4Rec", _TRANSFORMER, True),
    "TransformerRec-clm": ("TransformerRec", dict(_TRANSFORMER, backbone="gpt2",
                                                  objective="clm"), True),
    "TransformerRec-clm-last": ("TransformerRec", dict(_TRANSFORMER, backbone="gpt2",
                                                       objective="clm", loss_at="last"), True),
    "TransformerRec-plm": ("TransformerRec", dict(_TRANSFORMER, backbone="xlnet",
                                                  objective="plm"), True),
    "TransformerRec-rtd": ("TransformerRec", dict(_TRANSFORMER, backbone="electra",
                                                  objective="rtd"), True),
    "TIGER-rqvae": ("TIGER", dict(_TIGER, tokenizer="rqvae", scoring="beam"), True),
    "TIGER-rkmeans": ("TIGER", dict(_TIGER, tokenizer="rkmeans", scoring="exact"), True),
}

# name -> (class name, constructor arguments without the seed): the Ta Feng
# examples' settings
BASKET_CONFIGS = {
    "Beacon": ("Beacon", dict(emb_dim=2, rnn_unit=4, alpha=0.5, rnn_cell_type="LSTM",
                              n_epochs=15, batch_size=32, lr=0.001)),
    "DNNTSP": ("DNNTSP", dict(emb_dim=32, loss_type="bpr", lr=0.001, n_epochs=30,
                              batch_size=64)),
}
BASKET_METRICS = ("Recall@10", "Recall@50", "HitRatio@10")

# name -> (class name, constructor arguments without the seed, metrics)
AUX_CONFIGS = {
    "CVAECF": ("CVAECF", dict(z_dim=20, h_dim=20, autoencoder_structure=[40],
                              learning_rate=0.001, n_epochs=70), ("NDCG@50", "Recall@50")),
    "GCMC": ("GCMC", dict(max_iter=1000, learning_rate=0.01, train_early_stopping_patience=100),
             ("RMSE",)),
}


# the side-information models on make_ml100k_like(7) with
# seq_bench_data.side_modalities (a seeded trust graph, seeded image-like
# features, their k-NN item graph, TF-IDF-like text): name -> (class name,
# constructor arguments without the seed); SoRec and MCF at their examples'
# rates, the others at their examples' settings with larger minibatches and
# fewer epochs, so that a fit takes seconds on the card (VMF at lr 0.01: at
# its example's 0.001 ten epochs leave its saturated sigmoid at chance, AUC
# 0.50)
SIDE_CONFIGS = {
    "SoRec": ("SoRec", dict(k=5, max_iter=30, learning_rate=0.001, lambda_c=10,
                            lambda_reg=0.001)),
    "MCF": ("MCF", dict(k=10, max_iter=30, learning_rate=0.001)),
    "VBPR": ("VBPR", dict(k=10, k2=10, n_epochs=5, batch_size=500, learning_rate=0.005,
                          lambda_w=0.01, lambda_b=0.01, lambda_e=0.0, verbose=False)),
    "AMR": ("AMR", dict(k=10, k2=10, n_epochs=5, batch_size=500, learning_rate=0.005,
                        lambda_w=0.01, lambda_b=0.01, lambda_e=0.0, lambda_adv=1.0,
                        epsilon_adv=0.05, verbose=False)),
    "CausalRec": ("CausalRec", dict(k=10, k2=10, n_epochs=5, batch_size=500,
                                    learning_rate=0.005, lambda_w=0.01, lambda_b=0.01,
                                    lambda_e=0.0, tanh=1, lambda_2=0.8, verbose=False)),
    "VMF": ("VMF", dict(k=10, d=10, n_epochs=10, batch_size=500, learning_rate=0.01)),
    "DMRL": ("DMRL", dict(batch_size=1024, epochs=5, learning_rate=0.001, embedding_dim=100,
                          num_factors=4, num_neg=4)),
    "PCRL": ("PCRL", dict(k=100, z_dims=[300], max_iter=30, batch_size=300,
                          learning_rate=0.001)),
}
SIDE_METRICS = ("AUC", "NDCG@10", "Recall@10")

# the text and review models on make_ml100k_like(7) with
# seq_bench_data.text_modalities (a seeded document an item, a seeded
# review a rating): name -> (class name, constructor arguments without the
# seed). CDL at benchmarks/head_to_head_tf.py's configuration, NARRE and
# HRDR at narrower widths than its (embeddings 16, 8 filters, 4 reviews of
# 16 tokens) with larger minibatches, the others at their examples' settings
# with narrower widths and fewer epochs, so that a fit takes seconds on the
# card and an epoch of NARRE or HRDR on a CPU (the card witness's
# reference, in float32 and float64) a few seconds too
_REVIEW = dict(embedding_size=16, id_embedding_size=8, n_factors=8, attention_size=8,
               n_filters=8, max_text_length=16, max_num_review=4, batch_size=512, max_iter=2,
               verbose=False)
TEXT_CONFIGS = {
    "NARRE": ("NARRE", dict(_REVIEW)),
    "HRDR": ("HRDR", dict(_REVIEW, n_user_mlp_factors=16, n_item_mlp_factors=16)),
    "CDL": ("CDL", dict(k=32, autoencoder_structure=[64], act_fn="relu", lambda_u=0.1,
                        lambda_v=10, lambda_w=0.1, lambda_n=1000, corruption_rate=0.3,
                        learning_rate=0.001, batch_size=128, max_iter=30, verbose=False)),
    "CDR": ("CDR", dict(k=32, autoencoder_structure=[64], batch_size=512, max_iter=5,
                        verbose=False)),
    "CVAE": ("CVAE", dict(z_dim=32, vae_layers=(64, 32), n_epochs=10, batch_size=128,
                          verbose=False)),
    "ConvMF": ("ConvMF", dict(k=32, n_epochs=5, cnn_epochs=2, emb_dim=32, max_len=64,
                              num_filters=16, hidden_dim=32, verbose=False)),
    "CTR": ("CTR", dict(k=20, max_iter=10, lambda_v=1, verbose=False)),
    "HFT": ("HFT", dict(k=10, max_iter=10, grad_iter=5, lambda_text=0.01, verbose=False)),
}
REVIEW_MODELS = ("NARRE", "HRDR")  # rating models: banded on RMSE too

# the sentiment and explainable models on make_ml100k_like(7) with seeded
# timestamps and seeded sentiment (``sentiment_split``): name -> (class
# name, constructor arguments without the seed). EFM, MTER, LRPPM and
# TriRank at their examples' settings, MTER, ComparERSub, LRPPM and
# Companion at fewer iterations (500, 500, 1,000 and 300; the examples'
# 10,000, 200,000, 20,000 and 500,000: their eager iterations share the
# card's host with the other bench processes), HypAR at narrower widths (32 a node) and larger minibatches for
# one epoch (its defaults otherwise), the ComparER models on the first
# ``COMPARER_USERS`` users with consecutive purchases paired
# (``enum_window=2``): the skyline builds, host Python in both packages,
# take some minutes on all of them
_TUCKER8 = dict(n_user_factors=8, n_item_factors=8, n_aspect_factors=8, n_opinion_factors=8)
SENTIMENT_CONFIGS = {
    "EFM": ("EFM", dict(num_explicit_factors=40, num_latent_factors=60,
                        num_most_cared_aspects=15, rating_scale=5.0, alpha=0.85, max_iter=100)),
    "ComparERObj": ("ComparERObj", dict(num_explicit_factors=40, num_latent_factors=60,
                                        max_iter=100, enum_window=2)),
    "MTER": ("MTER", dict(n_user_factors=15, n_item_factors=15, n_aspect_factors=12,
                          n_opinion_factors=12, n_bpr_samples=1000, n_element_samples=50,
                          lambda_reg=0.1, lambda_bpr=10, max_iter=500, lr=0.1)),
    "ComparERSub": ("ComparERSub", dict(_TUCKER8, max_iter=500, lr=0.1, enum_window=2)),
    "LRPPM": ("LRPPM", dict(n_factors=8, ld=1.0, reg=0.01, alpha=1.0, n_samples=200,
                            n_ranking_samples=1000, max_iter=1000, lr=0.1)),
    "Companion": ("Companion", dict(_TUCKER8, n_element_samples=50, n_bpr_samples=1000,
                                    n_aspect_ranking_samples=1000,
                                    n_opinion_ranking_samples=1000, max_iter=300, lr=0.5)),
    "TriRank": ("TriRank", dict(max_iter=100, verbose=False)),
    "HypAR": ("HypAR", dict(node_dim=32, batch_size=1024, num_epochs=1, verbose=False)),
}
SENTIMENT_RATING = ("EFM", "ComparERObj", "MTER", "ComparERSub", "LRPPM", "Companion")
SENTIMENT_METRICS = ("AUC", "NDCG@10", "Recall@10")
COMPARER_USERS = 150  # the ComparER models' users: u0 .. u149


def sentiment_split(data, eval_methods, triples, name=None):
    """The sentiment cell: ``RatioSplit(0.15, 4.0, seed=123)`` of
    ``triples`` with seeded timestamps (``seq_bench_data.timed``) and seeded
    sentiment over 20 aspects and 60 opinions
    (``seq_bench_data.sentiment_lexicon``); for the ComparER models
    (``name``), the first ``COMPARER_USERS`` users' ratings only."""
    from seq_bench_data import sentiment_lexicon, timed

    lexicon = sentiment_lexicon(triples, n_aspects=20, n_opinions=60)
    quads = timed(triples)
    if name in ("ComparERObj", "ComparERSub"):
        keep = {f"u{u}" for u in range(COMPARER_USERS)}
        lexicon = [row for row in lexicon if row[0] in keep]
        quads = [row for row in quads if row[0] in keep]
    return eval_methods.RatioSplit(data=quads, fmt="UIRT", test_size=0.15, rating_threshold=4.0,
                                   exclude_unknowns=True, seed=123, verbose=False,
                                   sentiment=data.SentimentModality(data=lexicon))
TEXT_METRICS = ("AUC", "NDCG@10", "Recall@10")


def text_split(data, eval_methods, triples):
    """The text cell: ``RatioSplit(0.2, 4.0, seed=123)`` of ``triples`` with
    ``seq_bench_data.text_modalities``."""
    from seq_bench_data import text_modalities

    return eval_methods.RatioSplit(data=triples, test_size=0.2, rating_threshold=4.0,
                                   exclude_unknowns=True, seed=123, verbose=False,
                                   **text_modalities(triples, data))


def side_split(data, eval_methods, triples):
    """The side-information cell: ``RatioSplit(0.2, 4.0, seed=123)`` of
    ``triples`` with ``seq_bench_data.side_modalities``."""
    from seq_bench_data import side_modalities

    return eval_methods.RatioSplit(data=triples, test_size=0.2, rating_threshold=4.0,
                                   exclude_unknowns=True, seed=123, verbose=False,
                                   **side_modalities(triples, data))


FINGERPRINT_ROWS = 8


# the tables of the fits held to the JAX fit's own
FINGERPRINT_TABLES = {"SoRec": ("U", "V", "Z"), "MCF": ("U", "V", "Z"), "ConvMF": ("U", "V"),
                      "CTR": ("U", "V"), "HFT": ("gamma_u", "gamma_i", "beta_u", "beta_i")}


def fingerprint(model, name):
    """A fit's tables (``FINGERPRINT_TABLES[name]``) as {table: {"rows":
    the first ``FINGERPRINT_ROWS`` rows, "colsum": the column sums}}, plain
    lists."""
    return {table: {"rows": np.asarray(getattr(model, table))[:FINGERPRINT_ROWS].tolist(),
                    "colsum": np.asarray(getattr(model, table)).sum(axis=0).tolist()}
            for table in FINGERPRINT_TABLES[name]}


@functools.lru_cache(maxsize=1)
def _port_side_split():
    """The port's ``side_split`` of the bench data, built once."""
    import bench
    from cornac_tpu_torch import data as tdata, eval_methods as teval

    return side_split(tdata, teval, bench.make_ml100k_like())


def jax_dmrl_ranking(split, model):
    """AUC, NDCG@10 and Recall@10 of the JAX package's DMRL fitted on
    ``split`` (its ``side_split``), its parameters scored by the port's
    scorer on the CPU (``convert.model_from_params``): the JAX package's
    scorer runs the modality MLPs for every (user, item) pair, some 0.4 s a
    user here on a CPU, and the port's gives its scores within rtol 1e-5
    (``tests/test_torch_visual.py``)."""
    import cornac_tpu_torch
    from cornac_tpu_torch import metrics as tmetrics
    from cornac_tpu_torch.convert import model_from_params
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval

    cornac_tpu_torch.set_default_device("cpu")
    model.fit(split.train_set)
    port = _port_side_split()
    meta = {name: getattr(model, name) for name in (
        "num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
        "global_mean", "embedding_dim", "num_factors", "num_neg")}
    scorer = model_from_params("DMRL", model.params, meta, device="cpu",
                               train_set=port.train_set)
    return ranking_eval(scorer, [tmetrics.AUC(), tmetrics.NDCG(k=10), tmetrics.Recall(k=10)],
                        port.train_set, port.test_set, rating_threshold=4.0,
                        exclude_unknowns=True)[0]


def seq_eval(eval_methods, metrics, seed=123, data=None):
    """The next-item cell: ``gen_sessions``' split under
    ``NextItemEvaluation`` (mode 'next', unknown items excluded), and its
    three metrics; with a package's ``data`` module, the items carry
    ``session_features`` (TIGER reads them)."""
    from seq_bench_data import gen_sessions, session_features, session_split

    train, test = session_split(gen_sessions())
    extra = {}
    if data is not None:
        feats, ids = session_features()
        extra["item_feature"] = data.FeatureModality(features=feats, ids=ids)
    ev = eval_methods.NextItemEvaluation.from_splits(
        train_data=train, test_data=test, fmt="USIT", exclude_unknowns=True, seed=seed,
        mode="next", **extra)
    return ev, [metrics.MRR(), metrics.HitRatio(k=20), metrics.NDCG(k=20)]


def basket_eval(eval_methods, metrics, seed=123):
    """The next-basket cell: ``gen_baskets``' baskets under
    ``NextBasketEvaluation`` (a fifth of the users test), and its three
    metrics."""
    from seq_bench_data import gen_baskets

    ev = eval_methods.NextBasketEvaluation(data=gen_baskets(), test_size=0.2, fmt="UBI",
                                           seed=seed)
    return ev, [metrics.Recall(k=10), metrics.Recall(k=50), metrics.HitRatio(k=10)]


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
    table = next(t for t in (CONFIGS, GOLDEN_CONFIGS, SEQ_CONFIGS, GENERATIVE_CONFIGS,
                             AUX_CONFIGS, BASKET_CONFIGS, SIDE_CONFIGS, TEXT_CONFIGS,
                             SENTIMENT_CONFIGS) if name in t)
    cls, kwargs = table[name][:2]
    seeded = (True if table in (AUX_CONFIGS, BASKET_CONFIGS, SIDE_CONFIGS, TEXT_CONFIGS,
                                SENTIMENT_CONFIGS) else table[name][2])
    if seeded is not None:
        kwargs = {**kwargs, "seed": seed}
    return getattr(models, cls)(**kwargs)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(CONFIGS) + sorted(GOLDEN_CONFIGS)
                        + sorted(SEQ_CONFIGS) + sorted(GENERATIVE_CONFIGS) + sorted(AUX_CONFIGS)
                        + sorted(BASKET_CONFIGS) + sorted(SIDE_CONFIGS)
                        + sorted(TEXT_CONFIGS) + sorted(SENTIMENT_CONFIGS),
                        default="BPR")
    parser.add_argument("--seeds", type=int, nargs="+", default=None,
                        help="default: 123-127; 123-132 for the next-item and next-basket "
                             "models, CVAECF and GCMC")
    parser.add_argument("--package", choices=("jax", "torch"), default="jax")
    parser.add_argument("--fingerprint", action="store_true",
                        help="SoRec, MCF, ConvMF, CTR, HFT: print the first seed's fit's "
                             "FINGERPRINT_TABLES as their first FINGERPRINT_ROWS rows and column "
                             "sums instead of a band")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                        help="the port's device (--package torch)")
    parser.add_argument("--bf16-products", action="store_true",
                        help="JAX package only: every float32 matrix product in one bf16 pass")
    args = parser.parse_args()
    if args.bf16_products and args.package != "jax":
        parser.error("--bf16-products applies to the JAX package")
    if args.device != "cpu" and args.package != "torch":
        parser.error("--device applies to the port (--package torch)")

    if args.seeds is None:
        wide = any(args.model in t for t in (SEQ_CONFIGS, GENERATIVE_CONFIGS, AUX_CONFIGS,
                                             BASKET_CONFIGS, SIDE_CONFIGS, TEXT_CONFIGS,
                                             SENTIMENT_CONFIGS))
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

        cornac_tpu_torch.set_default_device(args.device)
        from cornac_tpu_torch import data, eval_methods, metrics, models
        from cornac_tpu_torch.eval_methods import RatioSplit
        from cornac_tpu_torch.eval_methods.base_method import ranking_eval, rating_eval
        from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall

    summary = {"model": args.model, "package": args.package, "device": args.device,
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

    if args.model in SEQ_CONFIGS or args.model in GENERATIVE_CONFIGS:
        generative = args.model in GENERATIVE_CONFIGS
        ev, seq_metrics = seq_eval(eval_methods, metrics, data=data if generative else None)
        seeds = args.seeds if (generative or SEQ_CONFIGS[args.model][2]) else args.seeds[:1]
        runs = []
        for seed in seeds:
            result = ev.evaluate(make_model(models, args.model, seed), seq_metrics,
                                 user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in SEQ_METRICS})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=seeds, **band_summary(runs, SEQ_METRICS))
        print(json.dumps(summary))
        return
    if args.model in BASKET_CONFIGS:
        ev, basket_metrics = basket_eval(eval_methods, metrics)
        runs = []
        for seed in args.seeds:
            result = ev.evaluate(make_model(models, args.model, seed), basket_metrics,
                                 user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in BASKET_METRICS})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=args.seeds, **band_summary(runs, BASKET_METRICS))
        print(json.dumps(summary))
        return
    if args.model in SIDE_CONFIGS:
        split = side_split(data, eval_methods, bench.make_ml100k_like())
        if args.fingerprint:
            model = make_model(models, args.model, args.seeds[0]).fit(split.train_set)
            summary.update(seed=args.seeds[0], fingerprint=fingerprint(model, args.model))
            print(json.dumps(summary))
            return
        ranking_metrics = [metrics.AUC(), metrics.NDCG(k=10), metrics.Recall(k=10)]
        runs = []
        for seed in args.seeds:
            if args.model == "DMRL" and args.package == "jax":
                values = jax_dmrl_ranking(split, make_model(models, "DMRL", seed))
            else:
                result = split.evaluate(make_model(models, args.model, seed), ranking_metrics,
                                        user_based=False)[0]
                values = [result.metric_avg_results[name] for name in SIDE_METRICS]
            runs.append(dict(zip(SIDE_METRICS, map(float, values))))
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=args.seeds, **band_summary(runs, SIDE_METRICS))
        print(json.dumps(summary))
        return
    if args.model in TEXT_CONFIGS:
        split = text_split(data, eval_methods, bench.make_ml100k_like())
        if args.fingerprint:
            model = make_model(models, args.model, args.seeds[0]).fit(split.train_set)
            summary.update(seed=args.seeds[0], fingerprint=fingerprint(model, args.model))
            print(json.dumps(summary))
            return
        names = TEXT_METRICS + (("RMSE",) if args.model in REVIEW_MODELS else ())
        text_metrics = [metrics.AUC(), metrics.NDCG(k=10), metrics.Recall(k=10)]
        if args.model in REVIEW_MODELS:
            text_metrics.append(metrics.RMSE())
        runs = []
        for seed in args.seeds:
            result = split.evaluate(make_model(models, args.model, seed), text_metrics,
                                    user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in names})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=args.seeds, **band_summary(runs, names))
        print(json.dumps(summary))
        return
    if args.model in SENTIMENT_CONFIGS:
        from cornac_tpu_torch.models.hypar import fixed_svds_start

        split = sentiment_split(data, eval_methods, bench.make_ml100k_like(), args.model)
        names = SENTIMENT_METRICS + (("RMSE",) if args.model in SENTIMENT_RATING else ())
        runs = []
        for seed in args.seeds:
            chosen = [metrics.AUC(), metrics.NDCG(k=10), metrics.Recall(k=10)] + (
                [metrics.RMSE()] if args.model in SENTIMENT_RATING else [])
            with fixed_svds_start(0):  # HypAR's content vectors from one svds start
                result = split.evaluate(make_model(models, args.model, seed), chosen,
                                        user_based=False)[0]
            runs.append({name: float(result.metric_avg_results[name]) for name in names})
            print(json.dumps({"model": args.model, "seed": seed, **runs[-1]}), flush=True)
        summary.update(seeds=args.seeds, **band_summary(runs, names))
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
