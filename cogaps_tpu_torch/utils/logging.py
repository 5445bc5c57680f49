"""Logging discipline — a copy of cogaps_tpu/utils/logging.py
(log_message, log_worker) without the JAX process-index check: the port
runs as one process (reference: src/utils/GapsPrint.h:3-15 and the
worker start/finish lines GapsRunner.cpp:429-433,495-501)."""

from __future__ import annotations

import sys


def log_message(msg: str) -> None:
    print(msg, file=sys.stdout, flush=True)


def log_worker(worker_id: int, msg: str) -> None:
    print(f"    worker {worker_id} {msg}", file=sys.stdout, flush=True)
