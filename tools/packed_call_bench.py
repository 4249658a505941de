#!/usr/bin/env python3
"""Host cost of a ctypes call with declared arguments against the same call
through ``cornac_tpu_torch.ops.native.PackedCall`` (the arguments packed in
one int64 array), at the canary's 5 arguments and ``accumulate_rows``'s 14.

Builds two C functions that return at once with g++ into a temporary
directory, calls each ``--calls`` times and prints one JSON line per
count: microseconds a call. Needs no card; the numbers are the host's.

    python3 tools/packed_call_bench.py [--calls 200000]
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cstdint>
extern "C" int declared5(int, void*, void*, long long, void*) { return 0; }
extern "C" int declared14(int, void*, void*, void*, long long, long long, long long, long long,
                          int, int, int, int, int, void*) { return 0; }
extern "C" int packed(const int64_t* args) { return (int)(args[0] & 0); }
"""


def per_call_us(fn, calls):
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e6 * (time.perf_counter() - t) / calls


def main():
    from cornac_tpu_torch.ops.native import PackedCall

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=200_000)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "bench.cpp", Path(tmp) / "libbench.so"
        src.write_text(SOURCE)
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                       check=True)
        lib = ctypes.CDLL(str(lib_path))
        ptr = ctypes.c_void_p
        lib.declared5.argtypes = [ctypes.c_int, ptr, ptr, ctypes.c_longlong, ptr]
        lib.declared14.argtypes = ([ctypes.c_int] + [ptr] * 3 + [ctypes.c_int64] * 4
                                   + [ctypes.c_int] * 5 + [ptr])
        for fn in (lib.declared5, lib.declared14):
            fn.restype = ctypes.c_int
        address = 1 << 46
        cases = {5: (lib.declared5, (0, address, address + 64, 16384, address + 128)),
                 14: (lib.declared14, (0, address, address + 64, address + 128, 1, 32768,
                                       10000, 33, 76, 33, 8, 256, 1, address + 256))}
        for n, (declared, values) in cases.items():
            packed = PackedCall(getattr(ctypes.CDLL(str(lib_path)), "packed"), n)
            print(json.dumps({"arguments": n,
                              "declared_us": per_call_us(lambda: declared(*values), args.calls),
                              "packed_us": per_call_us(lambda: packed(*values), args.calls)}),
                  flush=True)


if __name__ == "__main__":
    main()
