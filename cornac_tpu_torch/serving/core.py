"""Framework-agnostic serving logic, a port of
``cornac_tpu/serving/core.py``: model loading from env vars, and the three
endpoint handlers returning (payload, status) tuples. The stdlib server in
``standalone.py`` puts them behind HTTP; the JAX package's Flask app comes
in a later slice."""

import inspect
import os
from csv import writer
from datetime import datetime, timezone

from ..data import Dataset, Reader
from ..eval_methods import BaseMethod
from .. import metrics as _metrics_module

ALLOWED_METRIC_NAMES = {
    name: obj
    for name, obj in inspect.getmembers(_metrics_module)
    if inspect.isclass(obj) and obj.__module__.startswith(_metrics_module.__name__ + ".")
}

FEEDBACK_PATH = "data/feedback.csv"


def safe_eval_metric(metric_str):
    """Evaluate a metric constructor expression in a sandbox exposing only
    the metric classes (no builtins) — reference ``serving/app.py:41-46``."""
    code = compile(metric_str, "<string>", "eval")
    for name in code.co_names:
        if name not in ALLOWED_METRIC_NAMES:
            raise NameError(f"Use of {name} not allowed")
    return eval(code, {"__builtins__": {}}, ALLOWED_METRIC_NAMES)


def import_model_class(model_class):
    components = model_class.split(".")
    mod = __import__(".".join(components[:-1]), fromlist=[components[-1]])
    return getattr(mod, components[-1])


def load_model(instance_path="."):
    """(model, train_set) from MODEL_PATH / MODEL_CLASS / TRAIN_SET env."""
    model_path = os.environ.get("MODEL_PATH")
    model_class = os.environ.get("MODEL_CLASS")
    train_set_path = os.environ.get("TRAIN_SET")

    if model_path is None:
        raise ValueError("MODEL_PATH environment variable is not set.")
    if not os.path.isabs(model_path):
        model_path = os.path.join(os.path.dirname(instance_path), model_path)
    if model_class is None:
        raise ValueError("MODEL_CLASS environment variable is not set.")

    try:
        model = import_model_class(model_class).load(model_path)
    except Exception:
        from ..models import Recommender

        model = Recommender.load(model_path)

    train_set = None
    if train_set_path is not None:
        if not os.path.isabs(train_set_path):
            train_set_path = os.path.join(
                os.path.dirname(instance_path), train_set_path
            )
        train_set = Dataset.load(train_set_path)
    elif os.path.exists(train_set_path := model.load_from + ".trainset"):
        train_set = Dataset.load(train_set_path)

    return model, train_set


def handle_recommend(model, train_set, params):
    """GET /recommend -> (payload, status)."""
    if model is None:
        return "Model is not yet loaded. Please try again later.", 400

    uid = params.get("uid")
    k = int(params.get("k", -1))
    remove_seen = str(params.get("remove_seen", "false")).lower() == "true"

    if uid is None:
        return "uid is required", 400
    if remove_seen and train_set is None:
        return "Unable to remove seen items. 'train_set' is not provided", 400

    try:
        recommendations = model.recommend(
            user_id=uid, k=k, remove_seen=remove_seen, train_set=train_set
        )
    except ValueError as e:
        return str(e), 400

    return (
        {
            "recommendations": recommendations,
            "query": {"uid": uid, "k": k, "remove_seen": remove_seen},
        },
        200,
    )


def handle_feedback(params, data_fpath=FEEDBACK_PATH):
    """POST /feedback -> (payload, status); appends to the CSV log."""
    uid = params.get("uid")
    iid = params.get("iid")
    rating = params.get("rating", 1)
    time = datetime.now(timezone.utc)

    if uid is None:
        return "uid is required", 400
    if iid is None:
        return "iid is required", 400

    os.makedirs(os.path.dirname(data_fpath), exist_ok=True)
    with open(data_fpath, "a+", newline="") as f:
        writer(f).writerow([uid, iid, rating, time])

    return (
        {
            "message": "Feedback added",
            "data": {"uid": uid, "iid": iid, "rating": rating, "time": str(time)},
        },
        200,
    )


def handle_evaluate(model, train_set, query, data_fpath=FEEDBACK_PATH):
    """POST /evaluate -> (payload, status)."""
    if model is None:
        return "Model is not yet loaded. Please try again later.", 400
    if train_set is None:
        return "Unable to evaluate. 'train_set' is not provided", 400

    query_metrics = query.get("metrics")
    if not query_metrics:
        return "metrics is required", 400
    if not isinstance(query_metrics, list):
        return "metrics must be an array of metrics", 400

    exclude_unknowns = str(query.get("exclude_unknowns", "true")).lower() == "true"

    if "data" in query:
        data = query.get("data")
    else:
        data = []
        if os.path.exists(data_fpath):
            data = Reader().read(data_fpath, fmt="UIR", sep=",")

    if not data:
        return (
            "No feedback has been provided so far. No data available to "
            "evaluate the model.",
            400,
        )

    test_set = Dataset.build(
        data,
        fmt="UIR",
        global_uid_map=train_set.uid_map,
        global_iid_map=train_set.iid_map,
        exclude_unknowns=exclude_unknowns,
    )

    rating_threshold = query.get("rating_threshold", 1.0)
    user_based = str(query.get("user_based", "true")).lower() == "true"

    metrics = []
    for metric in query_metrics:
        try:
            metrics.append(safe_eval_metric(metric))
        except Exception:
            return (
                f"Invalid metric initiation: {metric}.\n"
                "Please input correct metrics (e.g., 'RMSE()', 'Recall(k=10)')",
                400,
            )

    rating_metrics, ranking_metrics = BaseMethod.organize_metrics(metrics)

    result = BaseMethod.eval(
        model=model,
        train_set=train_set,
        test_set=test_set,
        val_set=None,
        rating_threshold=rating_threshold,
        exclude_unknowns=exclude_unknowns,
        rating_metrics=rating_metrics,
        ranking_metrics=ranking_metrics,
        user_based=user_based,
        verbose=False,
    )

    metric_user_results = {}
    for metric, user_results in result.metric_user_results.items():
        metric_user_results[metric] = {
            train_set.user_ids[int(k)]: v for k, v in user_results.items()
        }

    return (
        {
            "result": dict(result.metric_avg_results),
            "user_result": metric_user_results,
        },
        200,
    )
