#!/usr/bin/env python3
"""Time the canary's and ``fused_topk``'s wrappers of one or more trees on
one card, in turns, beside their library yardsticks.

    python3 tools/wrapper_bench.py build/parent . --order ABBA

Each tree is a checkout that holds ``cornac_tpu_torch`` (unpack an older
commit with ``git archive`` into a directory ``.gitignore`` lists, such as
``build/``); A is the first tree given, B the second, and so on. Each turn
runs in a process of its own, which builds the tree's kernels into the
tree's ``build/``, and prints one JSON line per case:

- the canary ``CANARY(x)`` on (128, 128) float32 beside ``torch.mul(x, 2)``;
- ``FUSED_TOPK(U, V, 100)`` at B = 1, 256 and 8,192 users over V 17,700 x
  51 (``chip_smoke.py``'s serving shape; normal draws from seed 0) beside
  ``torch.topk(torch.matmul(U, V.T), 100)``.

For each: ``ms``, CUDA events over back-to-back calls (what a caller's
loop sees, the wrapper's host work included); ``host_ms``, the host's time
to enqueue one call (no sync in the loop); ``library_ms``, the yardstick
timed the same way in the same process. Needs a card; fails without one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from card_measure import card_line, time_ms  # noqa: E402


def host_ms(fn, reps):
    """The host's ms to enqueue one call of ``fn``, over ``reps`` calls."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    out = 1e3 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return out


def one(tree):
    """JSON lines of ``tree``'s canary and fused_topk times."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(tree))
    from cornac_tpu_torch.ops.canary import CANARY
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(128, 128, generator=gen, device="cuda")
    cases = [("canary (128, 128)", lambda: CANARY(x), lambda: torch.mul(x, 2), 500)]
    V = torch.randn(17_700, 51, generator=gen, device="cuda")
    U = torch.randn(8_192, 51, generator=gen, device="cuda")
    for B in (1, 256, 8_192):
        u = U[:B].contiguous()
        cases.append((f"fused_topk B={B}", lambda u=u: FUSED_TOPK(u, V, 100),
                      lambda u=u: torch.topk(torch.matmul(u, V.T), 100, dim=1),
                      20 if B == 8_192 else 200))
    for name, call, library, reps in cases:
        print(json.dumps(dict(tree=str(tree), case=name, ms=time_ms(call, reps),
                              host_ms=host_ms(call, reps),
                              library_ms=time_ms(library, reps))), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--order", default=None, help="turns, e.g. ABBA (default: each once)")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(Path(args.trees[0]).resolve())
        return
    print(card_line(), flush=True)
    trees = [Path(t).resolve() for t in args.trees]
    order = args.order or "".join(chr(ord("A") + i) for i in range(len(trees)))
    failed = 0
    for n, which in enumerate(order, 1):
        tree = trees[ord(which) - ord("A")]
        print(f"== turn {n}: {which} ({tree})", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)], capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                print(f"  {which} {r['case']}: {r['ms']:.4f} ms, host {r['host_ms']:.4f} ms, "
                      f"library {r['library_ms']:.4f} ms", flush=True)
        if proc.returncode != 0:
            failed += 1
            print(proc.stderr[-3000:], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
