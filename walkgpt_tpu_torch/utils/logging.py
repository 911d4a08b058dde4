"""Rotating run logger and profiler scope (a copy of
`walkgpt_tpu/utils/logging.py`; the trace is torch.profiler's, in place of
jax.profiler's).

Counterpart of the reference's logging setup (train_walkgpt.py:154-169:
`meta.log` rotated to `meta_N.log` on restart; evaluation_walkgpt.py:144-160
`eval.log`), plus profiler tracing in place of the reference's wall-clock
meters-only observability (SURVEY §5)."""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional


def setup_logging(log_dir: str, *, name: str = "meta",
                  rank: int = 0) -> Optional[logging.Logger]:
    """Rank-0 file+console logger; an existing {name}.log is rotated to the
    next free {name}_N.log before a fresh one starts."""
    if rank != 0:
        return None
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.log")
    if os.path.exists(path):
        n = 1
        while os.path.exists(os.path.join(log_dir, f"{name}_{n}.log")):
            n += 1
        os.rename(path, os.path.join(log_dir, f"{name}_{n}.log"))

    logger = logging.getLogger(f"walkgpt.{name}.{log_dir}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler scope over the host and, where there is one, the CUDA
    device, written to log_dir as a Chrome trace (trace.json); a no-op when
    log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
