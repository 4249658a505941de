#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two trees in turn on one card, to compare them
on the same machine.

    python3 tools/chip_smoke_ab.py build/parent . --order ABBA

A and B are checkouts that each hold a ``chip_smoke.py`` (unpack the older
commit with ``git archive`` into a directory ``.gitignore`` lists, such as
``build/``). Each run's whole output goes to ``<out>/<n>-<A|B>.log``
(``--out``, by default ``build/chip_smoke_ab``);
the lines that carry the trainers' and accumulate_rows' numbers are printed
as they come. Exits non-zero if any run fails.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

KEEP = ("device:", "times accumulate_rows", "BPR at the bench shape", "profile, 10 BPR epochs",
        "BPR k=32 batch", "profile, one epoch", "trainers:", "all phases ok",
        "accumulate_rows vs plain")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--order", default="ABBA")
    parser.add_argument("--out", default="build/chip_smoke_ab")
    args = parser.parse_args()
    trees = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = 0
    for n, which in enumerate(args.order, 1):
        tree = trees[which]
        log = out / f"{n}-{which}.log"
        t = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f,
                                stderr=subprocess.STDOUT).returncode
        print(f"== run {n}: {which} ({tree}), rc {rc}, {time.perf_counter() - t:.1f} s", flush=True)
        for line in log.read_text().splitlines():
            if any(k in line for k in KEEP):
                print(f"  {line.strip()}", flush=True)
        failed += rc != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
