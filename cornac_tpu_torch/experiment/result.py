"""Evaluation results rendered as the JAX package's
``cornac_tpu/experiment/result.py`` renders them (byte-identical tables):
one model on one split (``Result``) and one table per experiment
(``ExperimentResult``). The cross-validation and propensity-stratified
containers come with their eval methods (ROADMAP.md A6).
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


class ExperimentResult(list):
    """One :class:`Result` per model, rendered as a single comparison table."""

    def __str__(self):
        metrics = list(self[0].metric_avg_results.keys())
        grid = [metrics]
        grid += [_fmt_row(res.metric_avg_results[m] for m in metrics) for res in self]
        return _render_grid(grid, [res.model_name for res in self], rules=(1,))
