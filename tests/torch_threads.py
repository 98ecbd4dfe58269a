"""PyTorch's CPU threads in a test worker of the port's suite.

PyTorch sizes its intra-op pool to every core of the machine. Under
pytest-xdist each of N workers does so, and their pools' threads, which
spin while they wait, crowd each other off the cores: with 6 workers on
an 8-core CPU six of the port's heaviest test files took 1334 s of test
time (306 s of wall) with the default pools against 508 s (148 s) with
one thread a worker. `share_cores` gives each worker's PyTorch an equal
share of the cores (at least one); outside xdist it leaves PyTorch as it
is. Results do not depend on it beyond the summation order of a few CPU
reductions, which every bar of these tests covers.
"""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
