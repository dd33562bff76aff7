"""Torch's share of the host's cores in a pytest-xdist worker.

Imported by every ``test_torch_*`` module but the card's
(``test_torch_cuda.py``).  Under ``-n N`` each worker would run torch
with its default of one OpenMP thread per core, N times the cores in all,
and OpenMP's spinning waits then make the small ops of these tests 10-40x
slower than in a process alone.  A worker takes ``cpu_count // N``
threads (at least one), and its child processes (the CLI and bench
subprocesses, the gloo ranks) inherit it through ``OMP_NUM_THREADS``.
Outside xdist, or with ``OMP_NUM_THREADS`` set, nothing changes.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))

if WORKERS > 1 and "OMP_NUM_THREADS" not in os.environ:
    THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREADS)
    torch.set_num_threads(THREADS)
