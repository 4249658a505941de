"""The quality bands ``chip_smoke.py`` holds the port's fits to at the
bench shape (``make_ml100k_like(7)``, ``RatioSplit(0.2, 4.0, seed=123)``).

``python tools/bpr_quality_band.py --model NAME`` printed them on a CPU
from the JAX package's fits with seeds 123-127: (mean, spread) of AUC and
of NDCG@10 (and of RMSE, for FM), the spread the sample standard deviation;
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
}


def band(model, metric):
    """(low, high, mean, spread) of ``metric`` ("AUC", "NDCG@10", or "RMSE"
    where the entry has it) for ``model``."""
    mean, spread = BANDS[model][("AUC", "NDCG@10", "RMSE").index(metric)]
    half = DETERMINISTIC_TOL if spread is None else 3 * spread
    return mean - half, mean + half, mean, spread
