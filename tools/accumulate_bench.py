#!/usr/bin/env python3
"""Time ``accumulate_rows`` of one or more trees at the trainers' four
shapes, on one card, in turns.

    python3 tools/accumulate_bench.py build/parent . --order ABBA

Each tree is a checkout that holds ``cornac_tpu_torch`` (unpack an older
commit with ``git archive`` into a directory ``.gitignore`` lists, such as
``build/``); A is the first tree given, B the second, and so on. Each turn
runs in a process of its own, which builds the tree's kernel into the
tree's ``build/``. The inputs are ``chip_smoke.py``'s (``ACC_CASES``,
``accumulate_inputs``, from seed 0) of the checkout this script lies in,
so every turn sees the same ids and updates. For each shape a turn prints:

- ``ms``: CUDA events over 200 back-to-back calls of ``accumulate_rows``,
  what a trainer's loop sees, the wrapper's host time included;
- ``device``: the device time of the device events of one call, from
  ``torch.profiler`` over 20 calls, and how many events a call makes;
- ``host``: the host's time to enqueue one call (no sync in the loop).

Needs a card; fails without one.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (not the tree's)."""
    spec = importlib.util.spec_from_file_location("acc_bench_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree, reps=200, profiled=20):
    """Times of ``tree``'s accumulate_rows at the labelled ACC_CASES, as
    one JSON line per shape."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(tree))
    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    smoke = load_smoke()
    gen = torch.Generator(device=smoke.DEV).manual_seed(0)
    for label, R, B, d, kind, stride in smoke.ACC_CASES:
        inputs = smoke.accumulate_inputs(R, B, d, kind, stride, gen)
        if not label:
            continue
        table, ids, upd = inputs
        call = lambda: accumulate_rows(table, ids, upd)  # noqa: E731
        ms = smoke.time_ms(call, reps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            call()
        host_ms = 1e3 * (time.perf_counter() - t) / reps
        torch.cuda.synchronize()
        _, busy_ms, count, events = smoke.profile_call(lambda: [call() for _ in range(profiled)])
        print(json.dumps(dict(
            tree=str(tree), shape=label, ms=ms, device_ms=busy_ms / profiled,
            events_per_call=count / profiled, host_ms=host_ms,
            events=sorted(e.key[:60] for e in events))), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--order", default=None, help="turns, e.g. ABBA (default: each once)")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(Path(args.trees[0]).resolve())
        return
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
                print(f"  {which} {r['shape']}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
                      f"in {r['events_per_call']:g} events ({', '.join(r['events'])}), host "
                      f"{r['host_ms']:.4f} ms", flush=True)
        if proc.returncode != 0:
            failed += 1
            print(proc.stderr[-3000:], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
