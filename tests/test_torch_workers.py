"""The root `conftest.py`: each pytest-xdist worker's torch pool is its share
of the cores, and the processes it starts inherit that share; a run
without workers keeps torch's default."""
import os
import subprocess
import sys

import torch


def test_torch_threads_are_the_workers_share_of_the_cores():
    fresh = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True, timeout=300)
    child = int(fresh.stdout)
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert torch.get_num_threads() == child
        return
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    assert torch.get_num_threads() == share == child
    assert os.environ["OMP_NUM_THREADS"] == str(share)
