"""Ranks on this host: start `n` processes (torch.multiprocessing, the
spawn method), join them in one process group through
multihost.initialize_distributed, run a function in each, and fail if
any rank fails or outlives its time.

Each rank gets COGAPS_COORDINATOR (localhost and a free port),
COGAPS_NUM_PROCESSES and COGAPS_PROCESS_ID in its environment, as a
launcher on a cluster would set them, and runs fn(rank, n, *args): a
function importable by name (a module's top level), since spawn pickles
it by reference. Ranks that share one card take the gloo backend
(NCCL refuses two ranks on one GPU); their tensors stay on the card,
and multihost's collectives stage them through the host.
"""

from __future__ import annotations

import os
import socket
import time

import torch

from . import multihost


def free_port() -> int:
    """A TCP port on localhost that is free now (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: str, fn, args):
    os.environ.update({multihost.ENV_COORDINATOR: f"localhost:{port}",
                       multihost.ENV_NUM_PROCESSES: str(n),
                       multihost.ENV_PROCESS_ID: str(rank)})
    multihost.initialize_distributed(backend=backend, messages=True)
    try:
        fn(rank, n, *args)
    finally:
        torch.distributed.destroy_process_group()


def start(fn, n: int, *args, backend: str = "gloo"):
    """Start n ranks running fn(rank, n, *args); returns the handle that
    join() waits on."""
    import torch.multiprocessing as mp
    return mp.start_processes(_rank_main,
                              args=(n, free_port(), backend, fn, args),
                              nprocs=n, join=False, start_method="spawn")


def join(ranks, timeout: float = 120.0) -> None:
    """Wait for every rank to exit 0 within `timeout` seconds; kill them
    all and raise if one does not. A rank that raised re-raises here
    (torch.multiprocessing.ProcessRaisedException)."""
    deadline = time.monotonic() + timeout
    try:
        while not ranks.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        kill(ranks)


def kill(ranks) -> None:
    """Stop every rank of a group that is still running."""
    for p in ranks.processes:
        if p.is_alive():
            p.kill()
            p.join(5)
