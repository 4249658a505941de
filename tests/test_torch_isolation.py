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
from cornac_tpu_torch.ops.cosine_topk import cosine_topk
for name, call in (("default_device", cornac_tpu_torch.default_device),
                   ("fused_topk", lambda: fused_topk([[1.0]], [[1.0]], 1)),
                   ("cosine_topk", lambda: cosine_topk([[1.0], [2.0]], 1))):
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
                 "eval_methods.ratio_split", "experiment.experiment"):
        assert "cornac_tpu_torch." + name in probe["modules"]
    assert probe["leaked"] == []


def test_no_card_means_raise_unless_cpu_requested(probe):
    assert probe["default_device"].startswith("raised:")
    assert probe["fused_topk"].startswith("raised:")
    assert probe["cosine_topk"].startswith("raised:")
    assert probe["after_set"] == "cpu"
