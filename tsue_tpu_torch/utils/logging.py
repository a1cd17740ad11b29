"""Structured metric logging and seeding.

The port's copy of ``tsue_tpu/utils/logging.py``: a JSONL metric stream next
to the stdout echo (ref scripts/train.py:1220, 1326 print only), one seeding
helper for the host-side RNGs (ref scripts/seed_fix_train.py: 2-32), and
``profile_trace``, a ``torch.profiler`` trace of a block.  Device randomness
in the port flows through explicit ``torch.Generator``s, as the JAX
package's flows through explicit keys.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: int = 42):
    """Seed the host-side RNGs (splits, shuffles) and torch's default
    generator."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


class MetricLogger:
    """JSONL metrics + stdout echo (the port runs one process)."""

    def __init__(self, out_dir: str, name: str = "metrics",
                 echo: bool = True):
        self.echo = echo
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "item") or
                        isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            kv = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in rec.items() if k != "t")
            print(f"[{rec['t']:8.1f}s] {kv}", flush=True)

    def close(self):
        self._f.close()


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (host, and the CUDA device
    when there is one), written to ``out_dir`` as a Chrome trace
    (``trace.json``); a no-op for ``None``, as the JAX package's
    ``jax.profiler`` context."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
