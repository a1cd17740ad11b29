"""Runtime checks.

Counterpart of ``tsue_tpu/utils/checks.py``, whose ``checked`` runs a
function under ``jax.experimental.checkify`` so that NaN, division and
out-of-bounds errors raise.  PyTorch raises out-of-bounds indexing itself;
``checked`` here raises when a tensor the function returns holds a
non-finite value, naming the leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def _leaves(out: Any, path: str = "out") -> Iterator[Tuple[str, Any]]:
    if isinstance(out, torch.Tensor):
        yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _leaves(v, f"{path}[{i}]")


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a call raises ``FloatingPointError`` when a
    floating tensor it returns (in nested dicts, lists and tuples) is not
    finite.  The check reads one flag a tensor back, so the wrapped call
    waits for the device; ``fn`` itself is unchanged.

    Usage: loss = checked(train_step)(state, batch)"""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _leaves(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite values "
                    f"in {path}")
        return out

    return wrapper
