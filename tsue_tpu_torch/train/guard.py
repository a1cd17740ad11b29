"""Two drop-ins for ``GuardedAdamW``'s non-finite guard, wired into no
trainer.

Counterpart of ``tsue_tpu/train/guard.py`` (``apply_if_finite_fast``,
``clipped_apply_if_finite``), which the JAX package keeps unwired: on the
TPU neither beat ``optax.apply_if_finite`` (PARITY.md, "Joint train-step
profile").  Each is a ``GuardedAdamW`` whose probe differs; the skip rule
(a step with a non-finite gradient leaves the moments and Adam's step
count alone, until more than ``MAX_CONSECUTIVE_ERRORS`` such steps in a
row), the clip and the ``state_dict`` layout are ``GuardedAdamW``'s, so a
state restores into any of the three.

- ``MaxAbsGuardedAdamW``: one ``amax(|g|)`` a gradient, ``torch.maximum``
  across them, one ``isfinite`` of the result.  Both reductions propagate
  NaN, and |x| maxima never combine values, so it is finite exactly when
  every element is: the same decisions as the per-element check, and the
  all-finite trajectory bit for bit.
- ``ClipNormGuardedAdamW``: the clip's own global norm is the probe
  (NaN and Inf both reach a sum of squares; finite gradients overflow it
  only beyond |g| ~ 1.8e19), and the clip reuses that norm: one reduction
  over the gradients where the guard and the clip took two.  Its numbers
  equal ``GuardedAdamW``'s bit for bit, clipped or not (the norm is the
  clip's, computed once).

Both guard one process's gradients: under a mesh ``GuardedAdamW``'s
guard reads the global gradient through its own all-reduce, which these
probes do not replace.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from tsue_tpu_torch.train.trainer import GuardedAdamW, global_norm


def _one_process(opt: GuardedAdamW) -> None:
    if opt.mesh is not None:
        raise ValueError(f"{type(opt).__name__} guards one process's "
                         "gradients; under a mesh use GuardedAdamW")


class MaxAbsGuardedAdamW(GuardedAdamW):
    """``GuardedAdamW`` with the max-|x| probe (``apply_if_finite_fast``,
    ``tsue_tpu/train/guard.py:53``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _one_process(self)

    def _probe(self, grads: List[torch.Tensor]
               ) -> Tuple[bool, Optional[torch.Tensor]]:
        probe = None
        for g in grads:
            if g.numel() and g.is_floating_point():
                m = torch.amax(g.abs()).float()
                probe = m if probe is None else torch.maximum(probe, m)
        return probe is None or bool(torch.isfinite(probe)), None


class ClipNormGuardedAdamW(GuardedAdamW):
    """``GuardedAdamW`` whose probe is the clip's global norm
    (``clipped_apply_if_finite``, ``tsue_tpu/train/guard.py:99``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _one_process(self)

    def _probe(self, grads: List[torch.Tensor]
               ) -> Tuple[bool, Optional[torch.Tensor]]:
        norm = global_norm(grads)
        return bool(torch.isfinite(norm)), norm
