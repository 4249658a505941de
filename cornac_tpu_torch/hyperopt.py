"""Hyper-parameter search (Grid / Random), composable with Experiment.

Port of ``cornac_tpu/hyperopt.py``: the search wrappers are themselves
Recommenders (a clone of the model is fitted at each point, the best one
is kept and the scoring surface delegates to it), each trial scored on the
validation set by the port's eval harness. The trial points are the JAX
package's: a grid in sorted order, or draws from the model's seeded legacy
``RandomState``.
"""

from .eval_methods import ranking_eval, rating_eval
from .metrics import RatingMetric
from .models import Recommender
from .utils import get_rng

__all__ = ["Discrete", "Continuous", "GridSearch", "RandomSearch"]


class SearchDomain:
    """Named parameter domain; subclasses say how to enumerate/sample."""

    grid_capable = False

    def __init__(self, name):
        self.name = name

    def draw(self, rng):
        raise NotImplementedError("subclasses define how to draw a value")


class Discrete(SearchDomain):
    """Finite set of candidate values."""

    grid_capable = True

    def __init__(self, name, values):
        super().__init__(name=name)
        self.values = tuple(values)

    def draw(self, rng):
        return self.values[rng.randint(len(self.values))]

    def grid_points(self):
        return sorted(self.values)


class Continuous(SearchDomain):
    """Uniform range [low, high)."""

    def __init__(self, name, low=0.0, high=1.0):
        super().__init__(name=name)
        self.low, self.high = low, high

    def draw(self, rng):
        return self.low + (self.high - self.low) * rng.random_sample()


class BaseSearch(Recommender):
    """Clone-and-retrain search over a parameter space; behaves as the best
    found model afterwards."""

    def __init__(self, model, space, metric, eval_method, name="BaseSearch"):
        super().__init__(name=name, verbose=model.verbose)
        self.model = model
        self.space = sorted(space, key=lambda dom: dom.name)  # reproducible order
        self.metric = metric
        self.eval_method = eval_method

    def trial_points(self):
        raise NotImplementedError("subclasses enumerate/sample their trials")

    def _validation_score(self, model, train_set, val_set):
        """Score one fitted trial on the validation set with the eval
        function matching the metric type (rating or ranking — the same
        dispatch the composed eval_method would use). The JAX package's
        next-item branch (a ``NextItemRecommender`` scored by the next-item
        ``ranking_eval``) comes with the sequential models, which the port
        does not have yet (ROADMAP.md A10)."""
        if isinstance(self.metric, RatingMetric):
            return rating_eval(model, [self.metric], val_set)[0][0]
        return ranking_eval(
            model,
            [self.metric],
            train_set,
            val_set,
            rating_threshold=self.eval_method.rating_threshold,
            exclude_unknowns=self.eval_method.exclude_unknowns,
            verbose=False,
        )[0][0]

    def fit(self, train_set, val_set=None):
        if val_set is None:
            raise ValueError("hyperparameter search needs a validation set to score trials")
        Recommender.fit(self, train_set, val_set)

        # higher_better flips via a sign so one comparison serves both
        direction = 1.0 if self.metric.higher_better else -1.0
        self.trial_results = []  # (params, score) per evaluated point
        incumbent = None  # (signed score, raw score, params, model)

        for params in self.trial_points():
            if self.verbose:
                print("[{}] trying {}".format(self.name, params))
            trial = self.model.clone(params).fit(train_set, val_set)
            score = self._validation_score(trial, train_set, val_set)
            self.trial_results.append((params, score))
            if incumbent is None or direction * score > incumbent[0]:
                incumbent = (direction * score, score, params, trial)
            else:
                del trial  # free the losing trial's buffers eagerly

        _, self.best_score, self.best_params, self.best_model = incumbent
        if self.verbose:
            print(
                "[{}] best {} = {:.4f} at {}".format(
                    self.name, self.metric.name, self.best_score,
                    self.best_params,
                )
            )
        return self

    # after fit, the wrapper IS the best model: the whole scoring
    # surface delegates (generated below, one line per protocol method)


def _delegate_to_best(method):
    def call(self, *args, **kwargs):
        return getattr(self.best_model, method)(*args, **kwargs)

    call.__name__ = method
    return call


for _m in ("transform", "score", "score_batch", "score_pairs", "rank"):
    setattr(BaseSearch, _m, _delegate_to_best(_m))
del _m


class GridSearch(BaseSearch):
    """Cartesian product over Discrete domains."""

    def __init__(self, model, space, metric, eval_method):
        super().__init__(
            model,
            self._all_discrete(space),
            metric,
            eval_method,
            name="GridSearch_{}".format(model.name),
        )

    @staticmethod
    def _all_discrete(space):
        bad = [d.name for d in space if not d.grid_capable]
        if bad:
            raise ValueError(
                "GridSearch requires every domain to be Discrete; "
                "{} are not (RandomSearch handles Continuous "
                "domains)".format(bad)
            )
        return space

    def trial_points(self):
        axes = [(d.name, d.grid_points()) for d in self.space]
        points = [{}]
        for name_, values in axes:
            points = [
                {**pt, name_: v} for pt in points for v in values
            ]
        return points


class RandomSearch(BaseSearch):
    """n_trails points sampled from the domains."""

    def __init__(self, model, space, metric, eval_method, n_trails=10):
        super().__init__(
            model, space, metric, eval_method, name="RandomSearch_{}".format(model.name)
        )
        self.n_trails = n_trails

    def trial_points(self):
        rng = get_rng(getattr(self.model, "seed", None))
        return [
            {dom.name: dom.draw(rng) for dom in self.space}
            for _ in range(self.n_trails)
        ]
