#!/usr/bin/env python3
"""Build and run the port's kernels on the card once, each step timed.

The counterpart of ``benchmarks/pallas_on_silicon.py`` for the PyTorch and
CUDA port. Under a SIGALRM timeout per step, it builds (nvcc, at first use)
and runs:

1. the canary ``csrc/canary.cu`` (``o = 2 * x``) on one (128, 128) float32
   block, held to ``x * 2`` bit for bit; if it fails, nothing else is tried;
2. ``fused_topk`` at U 256 x 64, V 8,192 x 64, k = 100 (``RandomState(0)``
   normal draws) against ``fused_topk_torch``: the same ids, except swaps of
   entries whose plain scores lie within rtol 1e-5 / atol 1e-5 of each other,
   and scores within that tolerance;
3. ``cosine_topk`` at W 2,048 x 128 (normal draws), k = 20, against
   ``cosine_topk_torch``, the same rule at rtol 1e-5 / atol 1e-6.

Each step is timed cold (build or load of the library, first launch and a
synchronise, host clock) and warm (CUDA events over repeated launches), with
its plain version and the library yardstick (``torch.mul``; ``matmul`` +
``topk``; two ``matmul`` + ``topk``) warm beside it. A step that fails or times out is recorded with its
error; nothing falls back, and the script then exits non-zero. It writes
``build/cuda_silicon.json`` with the card's name and power limit.

    python3 tools/cuda_on_silicon.py [--timeout 240]
"""

import argparse
import json
import signal
import sys
import time
from pathlib import Path

import numpy as np

from card_measure import (PEAK_BYTES, PEAK_F32_FLOPS, card_line, compare_topk,
                          library_cosine_topk, plain_scores, time_ms)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "cuda_silicon.json"


class StepTimeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise StepTimeout()


def timed(fn, timeout):
    """Run ``fn()`` under a SIGALRM timeout: (its result, seconds, None) or
    (None, None, the error)."""
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(timeout)
    t0 = time.perf_counter()
    try:
        out = fn()
        return out, time.perf_counter() - t0, None
    except StepTimeout:
        return None, None, f"timed out after {timeout} s"
    except Exception as e:  # a failed build, launch or comparison
        return None, None, f"{type(e).__name__}: {e}"
    finally:
        signal.alarm(0)


def step_canary():
    import torch

    from cornac_tpu_torch.ops.canary import CANARY, scale2, scale2_torch

    x = torch.as_tensor(np.random.RandomState(0).randn(128, 128).astype(np.float32), device="cuda")
    built = CANARY.library.path().exists()
    t0 = time.perf_counter()
    y = scale2(x)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    if not torch.equal(y, scale2_torch(x)):
        raise AssertionError("the canary differs from x * 2")
    nbytes = 2.0 * x.numel() * 4
    return dict(shape=list(x.shape), cold_s=cold_s, built_before=built,
                build_s=CANARY.library.build_seconds, max_abs_err=0.0,
                ms=time_ms(lambda: CANARY(x), 200),
                plain_ms=time_ms(lambda: scale2_torch(x), 200),
                library_ms=time_ms(lambda: torch.mul(x, 2), 200),
                bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes")


def step_fused_topk():
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

    rng = np.random.RandomState(0)
    U = torch.as_tensor(rng.randn(256, 64).astype(np.float32), device="cuda")
    V = torch.as_tensor(rng.randn(8192, 64).astype(np.float32), device="cuda")
    k = 100
    built = FUSED_TOPK.library.path().exists()
    t0 = time.perf_counter()
    ks, ki = fused_topk(U, V, k)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    ps, pi = fused_topk_torch(U, V, k + 1)
    max_err, relaxed = compare_topk(ks, ki, ps, pi, plain_scores(U, V), "fused_topk", rtol=1e-5,
                                    atol=1e-5)
    flops, nbytes = 2.0 * 256 * 8192 * 64, 4.0 * (256 + 8192) * 64 + 8.0 * 256 * k
    return dict(shape=[256, 8192, 64, k], cold_s=cold_s, built_before=built,
                build_s=FUSED_TOPK.library.build_seconds, relaxed=relaxed, max_abs_err=max_err,
                ms=time_ms(lambda: FUSED_TOPK(U, V, k), 50),
                plain_ms=time_ms(lambda: fused_topk_torch(U, V, k), 50),
                library_ms=time_ms(lambda: torch.topk(U @ V.T, k, dim=1), 50),
                bound_ms=1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES),
                bound_by="operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes")


def step_cosine_topk():
    import torch

    from cornac_tpu_torch.ops.cosine_topk import (
        COSINE_TOPK, all_pairs_cosine, cosine_topk, cosine_topk_torch)

    W = torch.as_tensor(np.random.RandomState(1).randn(2048, 128).astype(np.float32), device="cuda")
    k = 20
    built = COSINE_TOPK.library.path().exists()
    t0 = time.perf_counter()
    ks, ki = cosine_topk(W, k)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    ps, pi = cosine_topk_torch(W, k + 1)
    max_err, relaxed = compare_topk(ks, ki, ps, pi, all_pairs_cosine(W), "cosine_topk",
                                    rtol=1e-5, atol=1e-6)
    n, m = W.shape
    # every pair of rows shares all m columns: 3 products of n x n x m
    flops, nbytes = 3 * 2.0 * n * n * m, 4.0 * n * m + 8.0 * n * k
    return dict(shape=[n, m, k], cold_s=cold_s, built_before=built,
                build_s=COSINE_TOPK.library.build_seconds, relaxed=relaxed, max_abs_err=max_err,
                ms=time_ms(lambda: cosine_topk(W, k), 10),
                plain_ms=time_ms(lambda: cosine_topk_torch(W, k), 10),
                library_ms=time_ms(lambda: library_cosine_topk(W, k), 10),
                bound_ms=1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES),
                bound_by="operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes")


STEPS = (("canary", step_canary), ("fused_topk", step_fused_topk),
         ("cosine_topk", step_cosine_topk))


def probe(timeout=240, out_path=OUT):
    """Run the three steps and write their record to ``out_path``. Returns
    the record; ``record["ok"]`` is False when any step failed."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    record = {"device": torch.cuda.get_device_name(0), "card": card_line(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "timeout_s": timeout, "steps": {}}
    for name, step in STEPS:
        if name != "canary" and record["steps"]["canary"]["error"] is not None:
            record["steps"][name] = {"error": "skipped: the canary failed"}
            continue
        result, seconds, err = timed(step, timeout)
        record["steps"][name] = {**(result or {}), "seconds": seconds, "error": err}
        print(f"[{name}] " + json.dumps(record["steps"][name]), file=sys.stderr, flush=True)
    record["ok"] = all(s["error"] is None for s in record["steps"].values())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    return record


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--timeout", type=int, default=240, help="seconds allowed each step")
    args = parser.parse_args()
    record = probe(args.timeout)
    print(json.dumps(record))
    sys.exit(0 if record["ok"] else 1)


if __name__ == "__main__":
    main()
