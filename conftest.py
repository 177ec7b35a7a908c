"""Root pytest configuration for the PyTorch port's tests.

Under pytest-xdist the workers share the machine's cores, and each worker's
torch would start one intra-op thread per core: at the tests' small shapes
those threads buy nothing alone, and in a full worker pool they wait on each
other and on the JAX tests' thread pools (a port test ran many times slower
in the suite than alone).  So inside an xdist worker, and only there, torch
gets the worker's share of the cores the process may run on.  A run without
xdist (one process, or the card tests) keeps torch's default.
"""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
