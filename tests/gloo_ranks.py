"""Four gloo ranks on the CPU, the harness of the port's ``mesh=`` test
files (``tests/test_torch_parallel_*.py``).

A test file's module-scoped fixture calls ``spawn_ranks(__file__,
outdir)``, which starts the file as a script four times (``python
<file> <rank> <port> <outdir>``), one process a rank with one thread. Each
rank's ``__main__`` calls ``join_group(rank, port)`` (the CPU as the
default device, the group joined by ``init_distributed`` at
``tcp://127.0.0.1:<port>``), computes its share, and rank 0 writes the
results with ``write_results``, which the fixture returns. The module's
name is not one pytest collects.
"""

import datetime
import os
import pickle
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAYOUTS = {"4x1": 4, "2x2": 2, "1x4": 1}  # name: data_parallel
RANK_TIMEOUT = 600  # seconds a rank's process may take
GROUP_TIMEOUT = 120  # seconds a collective may wait for the other ranks


def spawn_ranks(script, outdir):
    """Run ``script`` as ``WORLD`` ranks on a free local port and return the
    object rank 0 wrote to ``outdir``; a rank that fails fails the caller
    with the end of its log."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), str(r), str(port),
                               str(outdir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    with open(os.path.join(outdir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def join_group(rank, port):
    """In a rank's process: one thread, the CPU as the port's default
    device, and the group of ``WORLD`` ranks joined."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import cornac_tpu_torch
    from cornac_tpu_torch.parallel import init_distributed

    cornac_tpu_torch.set_default_device("cpu")
    init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=WORLD,
                     process_id=int(rank), timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))


def gather_shares(share):
    """Every rank's ``share`` (a dict), merged, on every rank."""
    import torch.distributed as dist

    shares = [None] * WORLD
    dist.all_gather_object(shares, share)
    out = {}
    for s in shares:
        out.update(s)
    return out


def write_results(outdir, out):
    """Rank 0 writes ``out`` for ``spawn_ranks``; every rank then leaves the
    group."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        with open(os.path.join(outdir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
