#!/usr/bin/env python3
"""How many device events ``torch.profiler`` keeps of a short kernel's
launches, in a fresh process and after profiles with many device events.

Profiles 20 launches of ``accumulate_rows`` (8,192 ids into 1,682 x 11, the
bench shape's V update) in a fresh process, then again after a profile of
20,000 and of 160,000 tiny elementwise kernels (about what one profiled
IBPR epoch at the bench shape gives), and once more with 0.2 s of idle
before and after the 20 launches inside the profile. Prints one JSON line
per step: the events kept of 20 and their mean device time. Needs one
card.

    python3 tools/profiler_loss_probe.py
"""

import json
import sys
import time
from pathlib import Path

from card_measure import card_line

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_events(fn):
    """(count, summed ms) of the device-side events of one profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def main():
    import torch

    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    if not torch.cuda.is_available():
        sys.exit("profiler_loss_probe: no CUDA device is available")
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    table = torch.randn(1682, 11, device="cuda", generator=gen)
    ids = torch.randint(1682, (8192,), device="cuda", generator=gen)
    upd = torch.randn(8192, 11, device="cuda", generator=gen)
    accumulate_rows(table, ids, upd)

    def launches(idle):
        time.sleep(idle)
        for _ in range(20):
            accumulate_rows(table, ids, upd)
        torch.cuda.synchronize()
        time.sleep(idle)

    def report(step, idle=0.0):
        kept, ms = device_events(lambda: launches(idle))
        print(json.dumps({"step": step, "kept_of_20": kept,
                          "device_ms_per_event": ms / kept if kept else None}), flush=True)

    def tiny(n):
        x = torch.zeros(64, device="cuda")
        for _ in range(n):
            x.add_(1)

    report("fresh process")
    report("fresh process, again")
    for n in (20_000, 160_000):
        t = time.perf_counter()
        device_events(lambda: tiny(n))
        print(json.dumps({"step": f"profiled {n} tiny kernels",
                          "seconds": time.perf_counter() - t}), flush=True)
        report(f"after a profile of {n} device events")
    report("the same, 0.2 s of idle on either side of the launches", idle=0.2)


if __name__ == "__main__":
    main()
