"""The quality bands ``chip_smoke.py`` holds the port's fits to at the
bench shape (``make_ml100k_like(7)``, ``RatioSplit(0.2, 4.0, seed=123)``).

``python tools/bpr_quality_band.py --model NAME`` printed them on a CPU
from the JAX package's fits with seeds 123-127: (mean, spread) of AUC and
of NDCG@10, the spread the sample standard deviation; a fit must land
within three spreads of the mean. The deterministic models (spread None)
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
}


def band(model, metric):
    """(low, high, mean, spread) of ``metric`` ("AUC" or "NDCG@10") for
    ``model``."""
    mean, spread = BANDS[model][("AUC", "NDCG@10").index(metric)]
    half = DETERMINISTIC_TOL if spread is None else 3 * spread
    return mean - half, mean + half, mean, spread
