"""Evaluation results rendered as the JAX package's
``cornac_tpu/experiment/result.py`` renders them (byte-identical tables):
one model on one split (``Result``), one table per experiment
(``ExperimentResult``), the per-fold table of cross-validation
(``CVResult``, one per model in a ``CVExperimentResult``) and the
propensity-stratified table with its unbiased row (``PSTResult``).
"""

from collections import OrderedDict

NUM_FMT = "{:.4f}"

_CELL_SEP = " | "
_RULE_SEP = " + "


def _render_grid(grid, labels=None, rules=()):
    """Render rows of string cells as an aligned monospace table.

    ``grid`` holds the header row followed by the value rows. Value cells are
    right-justified; the optional ``labels`` column (one label per row, header
    label implicitly blank) is left-justified and joined with the same
    ``" | "`` separator. ``rules`` lists row indices that get a dash rule
    (``"---- + ----"``) printed above them. Every line ends with a newline.
    """
    if labels is not None:
        grid = [[lab] + row for lab, row in zip([""] + list(labels), grid)]

    widths = [max(len(cell) for cell in column) for column in zip(*grid)]
    rule = _RULE_SEP.join("-" * w for w in widths) + "\n"

    lines = []
    for r, row in enumerate(grid):
        if r in rules:
            lines.append(rule)
        cells = [cell.rjust(w) for cell, w in zip(row, widths)]
        if labels is not None:
            cells[0] = row[0].ljust(widths[0])
        lines.append(_CELL_SEP.join(cells) + "\n")
    return "".join(lines)


def _fmt_row(values):
    return [NUM_FMT.format(v) for v in values]


class Result:
    """Evaluation outcome of a single model on one data split.

    Parameters
    ----------
    model_name: str
        Name of the recommender model.
    metric_avg_results: OrderedDict
        Metric name -> value averaged over the split.
    metric_user_results: OrderedDict
        Metric name -> per-user value arrays (None where not applicable).
    """

    def __init__(self, model_name, metric_avg_results, metric_user_results):
        self.model_name = model_name
        self.metric_avg_results = metric_avg_results
        self.metric_user_results = metric_user_results

    def __str__(self):
        grid = [
            list(self.metric_avg_results.keys()),
            _fmt_row(self.metric_avg_results.values()),
        ]
        return _render_grid(grid, labels=[self.model_name], rules=(1,))


class CVResult(list):
    """Per-fold :class:`Result` list for one model under cross-validation.

    ``organize()`` fills ``metric_mean`` / ``metric_std`` and builds the
    Fold/Mean/Std table.
    """

    def __init__(self, model_name):
        super().__init__()
        self.model_name = model_name
        self.metric_mean = OrderedDict()
        self.metric_std = OrderedDict()

    def __str__(self):
        return "[{}]\n{}".format(self.model_name, self.table)

    def organize(self):
        metrics = list(self[0].metric_avg_results.keys())
        folds = [[res.metric_avg_results[m] for m in metrics] for res in self]
        n = len(folds)

        for col, m in enumerate(metrics):
            samples = [fold[col] for fold in folds]
            mu = sum(samples) / n
            self.metric_mean[m] = mu
            self.metric_std[m] = (sum((x - mu) ** 2 for x in samples) / n) ** 0.5

        grid = [metrics]
        grid += [_fmt_row(fold) for fold in folds]
        grid.append(_fmt_row(self.metric_mean.values()))
        grid.append(_fmt_row(self.metric_std.values()))
        labels = ["Fold %d" % f for f in range(n)] + ["Mean", "Std"]
        self.table = _render_grid(grid, labels, rules=(1, n + 1))


class PSTResult(list):
    """Stratified :class:`Result` list for one model under propensity-based
    evaluation: Closed, IPS, then one quantile stratum per remaining entry.

    ``organize()`` appends the unbiased estimate — for each metric the
    size-weighted sum over strata ``sum_q (SIZE_q / SIZE_closed) * value_q``
    (the SIZE column itself reports the closed-loop size) — and builds the
    table.
    """

    def __init__(self, model_name):
        super().__init__()
        self.model_name = model_name

    def __str__(self):
        return "[{}]\n{}".format(self.model_name, self.table)

    def organize(self):
        metrics = list(self[0].metric_avg_results.keys())
        rows = [[res.metric_avg_results[m] for m in metrics] for res in self]
        closed_size = rows[0][metrics.index("SIZE")]
        sizes = [row[metrics.index("SIZE")] for row in rows]

        strata = rows[2:]  # everything past Closed and IPS
        unbiased = [
            sum(s * row[col] for s, row in zip(sizes[2:], strata)) / closed_size
            for col in range(len(metrics))
        ]
        unbiased[metrics.index("SIZE")] = closed_size

        self.append(
            Result(
                model_name=self[0].model_name,
                metric_avg_results=OrderedDict(zip(metrics, unbiased)),
                metric_user_results=None,
            )
        )

        labels = ["Closed", "IPS"]
        labels += ["Q%d" % q for q in range(1, len(strata) + 1)]
        labels.append("Unbiased")
        grid = [metrics] + [_fmt_row(row) for row in rows + [unbiased]]
        self.table = _render_grid(grid, labels, rules=(1, 2, 3, len(rows) + 1))


class ExperimentResult(list):
    """One :class:`Result` per model, rendered as a single comparison table."""

    def __str__(self):
        metrics = list(self[0].metric_avg_results.keys())
        grid = [metrics]
        grid += [_fmt_row(res.metric_avg_results[m] for m in metrics) for res in self]
        return _render_grid(grid, [res.model_name for res in self], rules=(1,))


class CVExperimentResult(ExperimentResult):
    """One :class:`CVResult` per model, rendered back to back."""

    def __str__(self):
        return "\n".join(str(res) for res in self)
