"""Give each process of the port's tests its share of the CPU.

The port's CPU emulations of its kernels are thousands of tiny torch ops.
torch runs each on an intra-op OpenMP pool of one thread per CPU, so six
``pytest -n 6`` workers on eight CPUs run six eight-thread pools that
spin against each other, and an emulation that takes half a second alone
takes over a minute.  Importing this module caps torch's pool at `SHARE`
threads, ``os.cpu_count() // workers`` (at least one), where ``workers``
is xdist's worker count (one outside xdist); a smaller count already set,
as by ``OMP_NUM_THREADS``, stays.  Every ``tests/test_torch_*.py``
imports it, and a subprocess the tests start gets the same share through
`subprocess_env`.  Only the tests pin threads: the package never touches
torch's global pool.
"""

import os

import torch

_WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

#: torch threads a test process may use
SHARE = max(1, (os.cpu_count() or 1) // _WORKERS)

if torch.get_num_threads() > SHARE:
    torch.set_num_threads(SHARE)


def subprocess_env(**extra):
    """This process's environment with ``OMP_NUM_THREADS`` at `SHARE`,
    plus ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS=str(SHARE), **extra)
