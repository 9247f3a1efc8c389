"""Caps torch's CPU threads for the port's test files (each imports this).

Under pytest-xdist every worker is a process of its own, and torch's CPU
ops use one OpenMP thread per core in each: six workers on eight cores run
48 threads, and a test made of many small ops then waits at each op's
barrier for threads that are not scheduled (the hisfrag train test ran
over 30 times slower under ``-n 6`` than alone). Each worker gets its
share of the cores instead; a run in one process keeps them all."""

import os

import torch


def cap_threads() -> int:
    workers = max(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")), 1)
    n = max(1, (os.cpu_count() or 1) // workers)
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
    return n


cap_threads()
