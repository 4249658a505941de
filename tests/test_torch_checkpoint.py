"""The port's checkpointed training, on the CPU.

- The format (``utils/checkpoint.py``): ``save_pytree`` / ``load_pytree``
  and ``CheckpointManager`` round trips of nested states (tensors, numpy
  arrays, Python scalars, None), restored into a template in place;
  ``max_to_keep``; an interrupted save leaving no checkpoint behind.
- Every trainer on ``epoch_loop`` (BPR, IBPR, LightGCN, MF on the SGD and
  the adam path, NeuMF, PMF, VAECF, WMF, and SBPR and VEBPR): a fit stopped
  after a few epochs with checkpoints on and resumed to the end in a fresh
  model equals the uninterrupted fit, bit for bit, and the checkpoints
  land where ``every`` says.
- ``Experiment(checkpoint_dir=)`` checkpoints every model under its name,
  and its table equals the one without checkpoints. The JAX package's
  ``tests/test_checkpoint_api.py`` holds the same contract for Orbax.
"""

import os
import sys
from collections import namedtuple

import numpy as np
import pytest
import torch

import cornac_tpu_torch
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import Experiment
from cornac_tpu_torch import models as P
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.metrics import AUC, NDCG
from cornac_tpu_torch.utils import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden_models as g  # noqa: E402
from bpr_quality_band import golden_split  # noqa: E402

cornac_tpu_torch.set_default_device("cpu")

Pair = namedtuple("Pair", "a b")


def _state():
    return {
        "tables": (torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   torch.tensor([1.5, -2.0])),
        "opt": {"count": torch.tensor(7, dtype=torch.int32),
                "mu": {"U": torch.ones(2, 2)}, "empty": {}},
        "host": np.array([3, 4], dtype=np.int64),
        "step": 5,
        "rate": 0.25,
        "none": None,
        "pair": Pair(torch.zeros(1), [torch.full((2,), 9.0)]),
    }


def test_save_and_load_round_trip(tmp_path):
    state = _state()
    ck.save_pytree(tmp_path / "one", state)
    flat = ck.load_pytree(tmp_path / "one")
    assert set(flat) == {"tables/0", "tables/1", "opt/count", "opt/mu/U", "host", "step",
                         "rate", "pair/0", "pair/1/0"}
    assert all(isinstance(t, torch.Tensor) for t in flat.values())

    template = _state()
    live = [template["tables"][0], template["opt"]["mu"]["U"], template["pair"].b[0]]
    for t in live:
        t.zero_()
    template["step"], template["rate"] = 0, 0.0
    template["host"] = np.zeros(2, np.int64)
    out = ck.load_pytree(tmp_path / "one", template)
    # tensor leaves are the template's own tensors, overwritten in place
    assert out["tables"][0] is live[0] and out["opt"]["mu"]["U"] is live[1]
    assert out["pair"].b[0] is live[2] and isinstance(out["pair"], Pair)
    torch.testing.assert_close(live[0], state["tables"][0], rtol=0, atol=0)
    torch.testing.assert_close(live[2], state["pair"].b[0], rtol=0, atol=0)
    assert out["opt"]["count"].dtype == torch.int32 and int(out["opt"]["count"]) == 7
    assert out["step"] == 5 and isinstance(out["step"], int)
    assert out["rate"] == 0.25 and out["none"] is None and out["opt"]["empty"] == {}
    np.testing.assert_array_equal(out["host"], state["host"])
    assert out["host"].dtype == np.int64

    # a checkpoint is read back without unpickling code
    path = tmp_path / "one" / "state.pt"
    torch.load(path, weights_only=True)

    bad = _state()
    bad["tables"] = (torch.zeros(3, 2), bad["tables"][1])
    with pytest.raises(ValueError, match="shape"):
        ck.load_pytree(tmp_path / "one", bad)
    with pytest.raises(KeyError):
        ck.load_pytree(tmp_path / "one", {"missing": torch.zeros(1)})
    ck.save_pytree(tmp_path / "one", {"x": torch.ones(1)})  # replaced
    assert set(ck.load_pytree(tmp_path / "one")) == {"x"}


def test_manager_keeps_the_newest(tmp_path):
    mgr = ck.CheckpointManager(tmp_path / "m", max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest() == (None, None)
    for step in (3, 1, 7, 5):
        assert mgr.save(step, {"w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [5, 7]
    assert not mgr.save(7, {"w": torch.zeros(2)})  # kept unless forced
    step, state = mgr.restore_latest()
    assert step == 7 and state["w"].tolist() == [7.0, 7.0]
    assert mgr.save(7, {"w": torch.zeros(2)}, force=True)
    assert mgr.restore(7)["w"].tolist() == [0.0, 0.0]
    template = {"w": torch.ones(2)}
    assert mgr.restore(5, template)["w"] is template["w"]
    assert template["w"].tolist() == [5.0, 5.0]
    mgr.close()


def test_interrupted_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(tmp_path / "m", max_to_keep=3)
    mgr.save(1, {"w": torch.ones(3)})
    real_save = torch.save

    def dies_midway(obj, f, *args, **kwargs):
        f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, {"w": torch.zeros(3)})
    with pytest.raises(KeyboardInterrupt):
        mgr.save(1, {"w": torch.zeros(3)}, force=True)
    monkeypatch.setattr(torch, "save", real_save)
    assert mgr.all_steps() == [1] and mgr.restore(1)["w"].tolist() == [1.0] * 3
    assert sorted(os.listdir(tmp_path / "m")) == ["1"]

    # a temporary directory left by a killed process is removed by the next
    # manager and never read as a checkpoint
    os.makedirs(tmp_path / "m" / ".tmp-4-123")
    (tmp_path / "m" / ".tmp-4-123" / "state.pt").write_bytes(b"partial")
    assert ck.CheckpointManager(tmp_path / "m").all_steps() == [1]
    assert sorted(os.listdir(tmp_path / "m")) == ["1"]


# ---------------------------------------------------------------- resumes


def _params(model):
    out = {}
    for name in ("u_factors", "i_factors", "i_biases", "u_biases", "U", "V"):
        value = getattr(model, name, None)
        if value is not None:
            out[name] = np.asarray(value)
    params = getattr(model, "params", None)
    if params is not None:
        out.update({f"params.{k}": v.detach().numpy().copy()
                    for k, v in params.state_dict().items()})
    return out


# name -> (epoch argument, constructor arguments, split kind)
TRAINERS = {
    "BPR": ("max_iter", dict(k=6, learning_rate=0.05, batch_size=128, seed=3), "implicit"),
    "IBPR": ("max_iter", dict(k=6, batch_size=256, seed=3), "implicit"),
    "LightGCN": ("num_epochs", dict(emb_size=8, num_layers=2, batch_size=256, seed=3),
                 "implicit"),
    "MF": ("max_iter", dict(k=6, batch_size=128, seed=3), "implicit"),
    "MF-adam": ("max_iter", dict(k=6, batch_size=128, optimizer="adam", dropout=0.1,
                                 seed=3), "implicit"),
    "NeuMF": ("num_epochs", dict(num_factors=4, layers=(16, 8, 4), batch_size=256,
                                 verbose=False, seed=3), "implicit"),
    "PMF": ("max_iter", dict(k=6, batch_size=128, seed=3), "implicit"),
    "VAECF": ("n_epochs", dict(k=4, autoencoder_structure=[12], batch_size=16, seed=3),
              "implicit"),
    "WMF": ("max_iter", dict(k=6, seed=3, verbose=False), "implicit"),
    "SBPR": ("max_iter", dict(k=6, learning_rate=0.05, batch_size=128, seed=3), "user_graph"),
    "VEBPR": ("max_iter", dict(k=6, learning_rate=0.05, batch_size=128, seed=3),
              "purchase_view"),
}


@pytest.fixture(scope="module")
def train_sets():
    implicit = RatioSplit(data=g.implicit_data(), test_size=0.2, rating_threshold=1.0,
                          seed=g.SEED).train_set
    return {"implicit": implicit,
            "user_graph": golden_split("user_graph", pdata, peval).train_set,
            "purchase_view": golden_split("purchase_view", pdata, peval).train_set}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_resumed_fit_equals_uninterrupted(tmp_path, train_sets, name, capsys):
    epoch_arg, kwargs, kind = TRAINERS[name]
    cls = P.MF if name.startswith("MF") else getattr(P, name)
    train = train_sets[kind]

    def make(epochs):
        return cls(**{epoch_arg: epochs}, **kwargs)

    straight = make(6).fit(train)
    make(4).enable_checkpointing(tmp_path, every=2, max_to_keep=5).fit(train)  # stopped at 4
    assert ck.CheckpointManager(tmp_path).all_steps() == [2, 4]
    resumed = make(6).enable_checkpointing(tmp_path, every=2, max_to_keep=5)
    resumed.verbose = True  # one epoch a chunk: the same bits, and it says where it resumed
    capsys.readouterr()
    resumed.fit(train)
    assert "Resumed from checkpoint at epoch 4" in capsys.readouterr().out
    assert ck.CheckpointManager(tmp_path).all_steps() == [2, 4, 6]
    want, got = _params(straight), _params(resumed)
    assert want and set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}: {key}")
    # a fit from scratch with checkpoints on is the same fit too, and a
    # model whose checkpointing is off again ignores the directory
    fresh = make(6).enable_checkpointing(tmp_path / "fresh", every=4).fit(train)
    assert ck.CheckpointManager(tmp_path / "fresh").all_steps() == [4, 6]
    again = make(6).enable_checkpointing(tmp_path).disable_checkpointing().fit(train)
    for model in (fresh, again):
        for key, value in _params(model).items():
            np.testing.assert_array_equal(value, want[key], err_msg=f"{name}: {key}")


def test_experiment_with_checkpoint_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    data = g.implicit_data()

    def run(**kw):
        split = RatioSplit(data=data, test_size=0.2, rating_threshold=1.0, seed=g.SEED)
        models = [P.BPR(k=6, max_iter=5, seed=3), P.MF(k=6, max_iter=5, seed=3),
                  P.VAECF(k=4, autoencoder_structure=[12], n_epochs=5, batch_size=16, seed=3)]
        exp = Experiment(split, models, [AUC(), NDCG(k=5)], **kw)
        exp.run()
        return exp

    plain = run()
    with_ck = run(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["BPR", "MF", "VAECF"]
    for name in ("BPR", "MF", "VAECF"):
        assert ck.CheckpointManager(tmp_path / "ck" / name).all_steps() == [2, 4, 5]
    for a, b in zip(plain.result, with_ck.result):
        for metric in ("AUC", "NDCG@5"):
            assert a.metric_avg_results[metric] == b.metric_avg_results[metric]
