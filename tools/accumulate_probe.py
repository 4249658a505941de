#!/usr/bin/env python3
"""Where ``csrc/accumulate_rows.cu`` spends its time, at the trainers' four
shapes, on one card.

    python3 tools/accumulate_probe.py

Builds three libraries into ``build/accumulate_probe/`` from the kernel's
source as it stands:

- the kernel with a ``%globaltimer`` stamp per block at the start, after
  the scan of the ids (the listing and the gather of the updates issued),
  after the wait for the gather, after the last sum and at the end; each
  stamp follows a barrier, so it adds a few of them;
- the kernel without the gather's ``cp.async`` (its sums are wrong; it
  times the scan without the copies);
- a bare read: every block of the same grid reads all B ids (512 threads,
  eight 16-byte loads a thread in flight) and does nothing else, the floor
  of a scan by row ownership.

For each of ``chip_smoke.py``'s four trainer cases (its ``ACC_CASES`` and
``accumulate_inputs``, seed 0) it prints the device time of one call of
each (``torch.profiler`` over 20 calls), whether the stamped kernel equals
the CPU plain version bit for bit, and per block the mean and the largest
time of each phase, with the phases of the block that ended last. It then
times the kernel again right after a second of large matrix products,
and gives the SM clock ``nvidia-smi`` read every 20 ms during both
timings: a card that idles between short kernels may not hold its clock.
Needs a card; fails without one.
"""

import ctypes
import importlib.util
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "accumulate_probe"
PHASES = ("scan", "wait", "sum", "write")

STAMPS = r"""
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ void stamp(int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[(blockIdx.x + blockIdx.y * gridDim.x) * 8 + k] = t;
  }
}
"""

READ_FLOOR = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(512, 1) read_ids(const longlong2* ids, int64_t pairs,
                                                   unsigned long long* sink) {
  unsigned long long x = 0;
  for (int64_t i = threadIdx.x; i < pairs; i += 512 * 8) {
    longlong2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = i + u * 512 < pairs ? ids[i + u * 512] : make_longlong2(0, 0);
#pragma unroll
    for (int u = 0; u < 8; ++u) x ^= v[u].x ^ v[u].y;
  }
  if (x == 0x5eedull) sink[0] = x;  // keeps the loads
}
extern "C" int read_floor(const void* ids, int64_t n, int grid, void* sink, void* stream) {
  read_ids<<<grid, 512, 0, (cudaStream_t)stream>>>((const longlong2*)ids, n / 2,
                                                   (unsigned long long*)sink);
  return (int)cudaGetLastError();
}
"""


def edit(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"accumulate_probe: the kernel's source changed; fix the anchor {old!r}")
    return src.replace(old, new)


def sources():
    """(stamped, without the gather) copies of the kernel's source."""
    src = (ROOT / "cornac_tpu_torch" / "csrc" / "accumulate_rows.cu").read_text()
    s = edit(src, "namespace {\n", "namespace {\n" + STAMPS)
    s = edit(s, "  extern __shared__ __align__(16) unsigned char smem[];\n",
             "  extern __shared__ __align__(16) unsigned char smem[];\n  stamp(0);\n")
    s = edit(s, "  cp_async_wait_all();\n  __syncthreads();\n  sum_staged<kCols>(n,",
             "  stamp(1);\n  cp_async_wait_all();\n  __syncthreads();\n  stamp(2);\n"
             "  sum_staged<kCols>(n,")
    s = edit(s, "  __syncwarp();\n\n  // the warp's touched rows", "  stamp(3);\n  __syncwarp();\n\n"
             "  // the warp's touched rows")
    s = edit(s, "t_old[u][t] + acc[r[u] * cols + c];\n      }\n    }\n  }\n}\n",
             "t_old[u][t] + acc[r[u] * cols + c];\n      }\n    }\n  }\n  stamp(4);\n}\n")
    s = edit(s, 'extern "C" {\n', 'extern "C" {\nint probe_stamps(unsigned long long* out, int n) {\n'
             '  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * n);\n}\n')
    no_gather = edit(src, "if (col < ncols) cp_async4(dst + col, src + col);", "(void)dst;")
    return s, no_gather


def build(name, text):
    from cornac_tpu_torch.ops import native

    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stdout + proc.stderr}")
    return ctypes.CDLL(str(so))


def bind(lib):
    lib.cornac_accumulate_rows_limits.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.cornac_accumulate_rows.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                           + [ctypes.c_int64] * 3 + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
    sms, smem = ctypes.c_int(), ctypes.c_int()
    if lib.cornac_accumulate_rows_limits(0, ctypes.byref(sms), ctypes.byref(smem)):
        raise SystemExit("cornac_accumulate_rows_limits failed")
    return sms.value, smem.value


class SmClock:
    """The SM clocks (MHz) ``nvidia-smi`` reads every 20 ms while the
    block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        self.mhz = [int(v) for v in out.split() if v.isdigit()]

    def __str__(self):
        return f"{min(self.mhz)}-{max(self.mhz)} MHz" if self.mhz else "no reading"


def burn(torch, seconds=1.0):
    """Keeps the card busy with large float32 products for ``seconds``."""
    a = torch.randn(8192, 8192, device="cuda")
    torch.cuda.synchronize()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(4):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("accumulate_probe: no CUDA device")
    import sys

    sys.path.insert(0, str(ROOT))
    from cornac_tpu_torch.ops.accumulate import accumulate_plan, accumulate_rows_torch

    spec = importlib.util.spec_from_file_location("acc_probe_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    OUT.mkdir(parents=True, exist_ok=True)
    stamped, no_gather = sources()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda a: build(*a), (("stamped", stamped),
                                                   ("no_gather", no_gather),
                                                   ("read_floor", READ_FLOOR))))
    stamped_lib, no_gather_lib, floor_lib = libs
    sms, smem = bind(stamped_lib)
    bind(no_gather_lib)
    stamped_lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    floor_lib.read_floor.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
    print(f"device: {torch.cuda.get_device_name(0)}, {sms} SMs, {smem} bytes of shared memory "
          f"a block", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    sink = torch.zeros(1, dtype=torch.int64, device="cuda")
    for label, R, B, d, kind, stride in smoke.ACC_CASES:
        table, ids, upd = smoke.accumulate_inputs(R, B, d, kind, stride, gen)
        if not label:
            continue
        plan = accumulate_plan(R, B, d, sms, smem)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib, t):
            err = lib.cornac_accumulate_rows(0, t.data_ptr(), upd.data_ptr(), ids.data_ptr(),
                                             ids.stride(0), B, R, d, plan.rows, plan.cols,
                                             plan.per_lane, plan.cap, stream)
            if err:
                raise SystemExit(f"launch failed: CUDA error {err}")

        def device_us(fn):
            for _ in range(3):
                fn()
            return 1e3 * smoke.profile_call(lambda: [fn() for _ in range(20)])[1] / 20

        dense = ids.contiguous()
        t = table.clone()
        with SmClock() as clock:
            kernel_us = device_us(lambda: launch(stamped_lib, t))
        no_gather_us = device_us(lambda: launch(no_gather_lib, t))
        floor_us = device_us(lambda: floor_lib.read_floor(dense.data_ptr(), B, plan.grid[0],
                                                          sink.data_ptr(), stream))
        burn(torch)
        with SmClock() as warm_clock:
            warm_us = device_us(lambda: launch(stamped_lib, t))
        t = table.clone()
        launch(stamped_lib, t)
        torch.cuda.synchronize()
        exact = torch.equal(t.cpu(), accumulate_rows_torch(table.cpu(), ids.cpu(), upd.cpu()))
        blocks = plan.grid[0] * plan.grid[1]
        buf = (ctypes.c_ulonglong * (blocks * 8))()
        if stamped_lib.probe_stamps(buf, blocks * 8):
            raise SystemExit("probe_stamps failed")
        stamps = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, 8)[:, :5].astype(np.int64)
        phases = np.diff(stamps, axis=1) / 1e3
        last = int(np.argmax(stamps[:, 4]))
        print(f"{label}: {B} ids into {R} x {d}, grid {plan.grid}, {plan.rows} rows a block; "
              f"device {kernel_us:.2f} us with the stamps (bit for bit the CPU plain version: "
              f"{exact}), {no_gather_us:.2f} us without the gather, bare read of the ids by "
              f"{plan.grid[0]} blocks {floor_us:.2f} us; span of the blocks "
              f"{(stamps[:, 4].max() - stamps[:, 0].min()) / 1e3:.2f} us; SM clock {clock}; "
              f"after a second of products {warm_us:.2f} us, SM clock {warm_clock}", flush=True)
        print("    per block, mean / largest us: "
              + ", ".join(f"{p} {phases[:, i].mean():.2f} / {phases[:, i].max():.2f}"
                          for i, p in enumerate(PHASES))
              + "; the last block: " + ", ".join(f"{p} {phases[last, i]:.2f}"
                                                 for i, p in enumerate(PHASES)), flush=True)


if __name__ == "__main__":
    main()
