"""The quality bands ``chip_smoke.py`` holds the port's fits to at the
bench shape (``make_ml100k_like(7)``, ``RatioSplit(0.2, 4.0, seed=123)``).

``python tools/bpr_quality_band.py --model NAME`` printed them on a CPU
from the JAX package's fits with seeds 123-127: (mean, spread) of AUC and
of NDCG@10 (and of RMSE, for FM; of the train AUC alone for the models fitted
on ``tests/golden_models.py``'s block data), the spread the sample standard
deviation;
a fit must land within three spreads of the mean. The deterministic models (spread None)
were fitted once, and their band is the value +/- ``DETERMINISTIC_TOL``.
"""

# A deterministic fit on the card differs from the CPU's only in the order
# of float32 sums, which moves a score by about 1e-6 of its size: enough to
# swap near-tied items in a few users' top ten (each moves NDCG@10 by about
# 1e-4 on 900 test users), far from a change of the model.
DETERMINISTIC_TOL = 1e-3

BANDS = {
    "BPR": ((0.9336642863641741, 5.575300253011466e-05),
            (0.1627065971857164, 0.0029556236688647887)),
    "PMF": ((0.8714205226867854, 0.00121827280447668),
            (0.24433772493457995, 0.0045429131768804365)),
    "NMF": ((0.6540466039772378, None), (0.0246556193695215, None)),
    "WMF": ((0.9252230612875169, None), (0.37549624675815707, None)),
    "EASE": ((0.9479783401762314, None), (0.43122123662986783, None)),
    "IBPR": ((0.912051328267677, 0.0010897351440815307),
             (0.1201333918111954, 0.014842162022077427)),
    "COE": ((0.9312031553254274, 0.0003835705883507556),
            (0.18800781878029427, 0.0037357126626665084)),
    "MF-adam": ((0.6446108506630992, 0.0019435939338328962),
                (0.03160898657802054, 0.0024221526956530654)),
    "VAECF": ((0.9336208911108945, 3.922454413960078e-05),
             (0.16372374304405324, 0.0025435135610025472)),
    "RecVAE": ((0.9343017741579519, 0.00020291588864249432),
              (0.11944712108417888, 0.0036133350688882333)),
    "BiVAECF": ((0.9314102263743905, 0.00039250351566921755),
               (0.1720670542892065, 0.0030637735423902526)),
    "GMF": ((0.9338737448351507, 0.00019642024641436975),
           (0.16919348157412933, 0.004201389376582616)),
    "MLP": ((0.9335706869466179, 0.00023623657314098098),
           (0.1666291310482541, 0.004741205404178555)),
    "NeuMF": ((0.9413218358667885, 0.0009719574460930232),
             (0.2754008581472733, 0.013069269129053316)),
    "LightGCN": ((0.93370604357057, 0.00010424082574821262),
                (0.17045347762006718, 0.004557508809276959)),
    "NGCF": ((0.9376181031335322, 0.0006383643274234236),
            (0.20914533125633655, 0.011723150635304316)),
    # the factor family's rest; the FM entries carry RMSE third
    "HPF": ((0.9416040610028223, None),
            (0.3975118435800771, None)),
    "PF": ((0.9392342669207875, None),
           (0.34801643653866593, None)),
    "SKMeans": ((0.935726370690104, None),
                (0.21769408678610278, None)),
    "FM-als": ((0.5954038162812441, None),
               (0.0004884774865508248, None),
               (0.8035231064239835, None)),
    "FM-sgd": ((0.7267625525859469, 0.012015919624494975),
               (0.11560790781846834, 0.004025282227839214),
               (0.7873132544058109, 0.002357494843873768)),
    "FM-mcmc": ((0.7344867617606281, 0.002297659188937873),
                (0.03194185589975693, 0.003388039534222481),
                (0.8132974881598496, 0.002145796482107631)),
    "SANSA": ((0.9422985840130057, None),
              (0.4150239678925398, None)),
    # the models that read a modality, on tests/golden_models.py's block
    # data: the train AUC alone (golden_models.train_auc)
    "SBPR": ((0.8576370205310673, 0.0046771719870914346),),
    "VEBPR": ((0.8369048928847503, 0.0007231961079112852),),
    "C2PF": ((0.8742257146136561, None),),
    "TC2PF": ((0.8521704503120568, None),),
    "RC2PF": ((0.850123914677608, None),),
}


def band(model, metric):
    """(low, high, mean, spread) of ``metric`` ("AUC", "NDCG@10", or "RMSE"
    where the entry has it) for ``model``."""
    mean, spread = BANDS[model][("AUC", "NDCG@10", "RMSE").index(metric)]
    half = DETERMINISTIC_TOL if spread is None else 3 * spread
    return mean - half, mean + half, mean, spread


# The next-item models on seq_bench_data.gen_sessions' sessions
# (NextItemEvaluation.from_splits, mode 'next': MRR, HitRatio@20, NDCG@20),
# CVAECF (NDCG@50, Recall@50) and GCMC (RMSE) on make_ml100k_like(7):
# (mean, spread) of each metric from ``tools/bpr_quality_band.py --model
# NAME`` (JAX package, CPU, ten seeds, 123-132: five misjudged GRU4Rec's MRR
# spread by a factor of two; SPop is deterministic). A card's fit draws
# another stream than the CPU's; ``chip_smoke.gru4rec_witness`` holds
# GRU4Rec's training on the card to the CPU's on the same draws.
SEQ_BANDS = {
    "SPop": {"MRR": (0.02066732744202636, None), "HitRatio@20": (0.05619146722164412, None),
             "NDCG@20": (0.02387006778085176, None)},
    "FPMC": {"MRR": (0.7009480376300465, 0.008919269755237722),
            "HitRatio@20": (0.8026014568158167, 0.0013699908191586237),
            "NDCG@20": (0.7238179053232598, 0.006956791986316601)},
    "GRU4Rec": {"MRR": (0.8197976343180695, 0.0007442010234545375),
               "HitRatio@20": (0.8781997918834547, 0.003896978836841064),
               "NDCG@20": (0.829873179015026, 0.0011844042912346983)},
    "SASRec": {"MRR": (0.8054126744312953, 0.003729429936119365),
              "HitRatio@20": (0.874089490114464, 0.0036296305127526823),
              "NDCG@20": (0.8182169598861948, 0.0027567065240796705)},
    "CVAECF": {"NDCG@50": (0.5420523512179062, 0.00022777890532817475),
              "Recall@50": (0.7545760241344626, 9.978442452688747e-05)},
    "GCMC": {"RMSE": (0.7406408624374798, 0.009185807801493662)},
    # the generative next-item models (process 12h) on the same sessions,
    # TIGER over seq_bench_data.session_features: the configurations of
    # tools/bpr_quality_band.py's GENERATIVE_CONFIGS (BERT4Rec and
    # TransformerRec at d 64, two blocks of two heads, max_len 20, 10 epochs
    # of 64 sessions at lr 0.005; TIGER with two levels of 16 codes, d_model
    # 32, one encoder and one decoder block, 5 epochs), from
    # ``python tools/bpr_quality_band.py --model NAME`` (ten seeds, 123-132);
    # ``chip_smoke.generative_witness`` holds their training on the card to
    # the CPU's on the same draws
    "BERT4Rec": {"MRR": (0.2291511184110519, 0.009788477574717744), "HitRatio@20": (0.7503642039542143, 0.016123996394198804), "NDCG@20": (0.34102499855827106, 0.011559218233740735)},
    "TransformerRec-clm": {"MRR": (0.8187739199560882, 0.001613146016473731), "HitRatio@20": (0.8789281997918834, 0.0032543059068676407), "NDCG@20": (0.8293104508014769, 0.001708801093154621)},
    "TransformerRec-clm-last": {"MRR": (0.6469906358063313, 0.023926543986933165), "HitRatio@20": (0.8077523413111342, 0.005748114262634939), "NDCG@20": (0.6827027502138382, 0.018276642997385645)},
    "TransformerRec-plm": {"MRR": (0.17266183215994585, 0.07077392715819547), "HitRatio@20": (0.5532258064516129, 0.21134606195186956), "NDCG@20": (0.25092387157727475, 0.10302783482305378)},
    "TransformerRec-rtd": {"MRR": (0.21372344324337886, 0.03689500876906335), "HitRatio@20": (0.7258584807492195, 0.09875595162527616), "NDCG@20": (0.32137820923179666, 0.05380846245204053)},
    "TIGER-rqvae": {"MRR": (0.5835558368368609, 0.031089074950825392), "HitRatio@20": (0.8649843912591051, 0.005695546955835246), "NDCG@20": (0.6474248542416192, 0.02449168991637448)},
    "TIGER-rkmeans": {"MRR": (0.4602196758454692, 0.05072567833638084), "HitRatio@20": (0.8404266389177939, 0.012317347837437688), "NDCG@20": (0.542987694041402, 0.0424577120260151)},
}


def seq_band(model, metric):
    """(low, high, mean, spread) of ``metric`` for ``model`` in
    ``SEQ_BANDS``."""
    mean, spread = SEQ_BANDS[model][metric]
    half = DETERMINISTIC_TOL if spread is None else 3 * spread
    return mean - half, mean + half, mean, spread


# The next-basket models on seq_bench_data.gen_baskets' baskets
# (NextBasketEvaluation(test_size=0.2, seed=123): 60 test users), at the Ta
# Feng examples' settings: (mean, spread) of Recall@10, Recall@50 and
# HitRatio@10 from ``python tools/bpr_quality_band.py --model Beacon`` and
# ``--model DNNTSP`` (JAX package, CPU, ten seeds, 123-132). A card's fit
# draws another stream than the CPU's; ``chip_smoke.basket_witness`` holds
# one epoch of each on the card to the CPU's on the same draws.
BASKET_BANDS = {
    "Beacon": {"Recall@10": (0.11430555555555555, 0.024198839801457952),
               "Recall@50": (0.43472222222222223, 0.015943680886780155),
               "HitRatio@10": (0.30666666666666664, 0.056218269514104524)},
    "DNNTSP": {"Recall@10": (0.12180555555555554, 0.02738964952741396),
               "Recall@50": (0.48624999999999996, 0.04245372894704205),
               "HitRatio@10": (0.3183333333333333, 0.054120350568700244)},
}


def basket_band(model, metric):
    """(low, high, mean, spread) of ``metric`` for ``model`` in
    ``BASKET_BANDS``."""
    mean, spread = BASKET_BANDS[model][metric]
    return mean - 3 * spread, mean + 3 * spread, mean, spread
