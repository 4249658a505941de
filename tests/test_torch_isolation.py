"""The port stands alone: importing every module of ``cornac_tpu_torch``
loads neither JAX nor anything of the JAX package, and without a card its
entry points refuse to run unless the CPU was asked for."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# one clean interpreter for both checks: this test process has JAX loaded
_PROBE = """
import importlib, json, pkgutil, sys
import torch
import cornac_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cornac_tpu_torch.__path__, "cornac_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "cornac_tpu" or m.startswith("cornac_tpu."))
out = {"modules": names, "leaked": leaked}

torch.cuda.is_available = lambda: False  # no card, whatever this host has
from cornac_tpu_torch.ops.fused_topk import fused_topk
from cornac_tpu_torch.ops.canary import scale2
from cornac_tpu_torch.ops.cosine_topk import cosine_topk
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.models import DNNTSP, TIFUKNN
from scipy.sparse import csr_matrix
for name, call in (("default_device", cornac_tpu_torch.default_device),
                   ("fused_topk", lambda: fused_topk([[1.0]], [[1.0]], 1)),
                   ("scale2", lambda: scale2([1.0])),
                   ("cosine_topk", lambda: cosine_topk([[1.0], [2.0]], 1)),
                   ("build_membership", lambda: build_membership(csr_matrix((2, 2)))),
                   ("TIFUKNN", lambda: TIFUKNN()._device()),
                   ("DNNTSP", lambda: DNNTSP()._device())):
    try:
        out[name] = str(call())
    except RuntimeError as e:
        out[name] = "raised: " + str(e)
cornac_tpu_torch.set_default_device("cpu")
out["after_set"] = str(cornac_tpu_torch.default_device())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package(probe):
    for name in ("serving.standalone", "ops.fused_topk", "ops.cosine_topk", "models.knn",
                 "eval_methods.ratio_split", "experiment.experiment", "ops.accumulate",
                 "ops.membership", "utils.checkpoint", "models.mf", "models.mmmf",
                 "models.baseline", "ops.canary", "ops.optim", "ops.dense_scores",
                 "models.pmf", "models.nmf", "models.ease", "models.wmf", "models.ibpr",
                 "convert", "data.dataset", "engine.nn", "models.vaecf", "models.recvae",
                 "models.bivaecf", "models.ncf", "models.lightgcn", "ops.graph",
                 "models.hpf", "models.skm", "models.fm", "models.sansa", "ops.sparse_chol",
                 "eval_methods.stratified_split", "eval_methods.timestamp_split",
                 "eval_methods.cross_validation",
                 "eval_methods.propensity_stratified_evaluation", "experiment.result",
                 "hyperopt", "config", "data.modality", "data.graph", "data.image",
                 "data.sentiment", "data.text", "data.reader", "models.sbpr", "models.c2pf",
                 "models.vebpr", "utils.profiling", "utils.fast_dot", "utils.download",
                 "datasets.epinions", "datasets.amazon_office", "datasets.movielens",
                 "native", "native.build", "models.seq_utils",
                 "models.spop", "models.fpmc", "models.gru4rec", "models.sasrec",
                 "models.cvaecf", "models.gcmc", "eval_methods.next_item_evaluation",
                 "models.basket", "models.beacon", "models.dnntsp",
                 "eval_methods.next_basket_evaluation", "ops.rmsprop", "models.sorec",
                 "models.mcf", "models.vbpr", "models.causalrec", "models.vmf", "models.dmrl",
                 "models.pcrl", "models.review_utils", "models.narre", "models.hrdr",
                 "models.cdl", "models.cvae", "models.convmf", "models.ctr", "models.hft"):
        assert "cornac_tpu_torch." + name in probe["modules"]
    assert probe["leaked"] == []


def test_no_card_means_raise_unless_cpu_requested(probe):
    assert probe["default_device"].startswith("raised:")
    assert probe["fused_topk"].startswith("raised:")
    assert probe["scale2"].startswith("raised:")
    assert probe["cosine_topk"].startswith("raised:")
    assert probe["build_membership"].startswith("raised:")
    assert probe["TIFUKNN"].startswith("raised:") and probe["DNNTSP"].startswith("raised:")
    assert probe["after_set"] == "cpu"


_SCRIPT_PROBE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("under_test", sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "cornac_tpu" or m.startswith("cornac_tpu."))))
"""


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/card_measure.py",
                                    "tools/quality_bands.py", "tools/seq_bench_data.py",
                                    "tools/cuda_on_silicon.py",
                                    "tools/profiler_loss_probe.py", "tools/wrapper_bench.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts that run on the card load as modules (tools/ on the
    path, as when they run) without JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tools")])
    proc = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, str(ROOT / script)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
