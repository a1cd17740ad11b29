"""Baseline trajectory models (SURVEY.md §2.4 B1-B7).

Counterpart of ``tsue_tpu/models/baselines``: each is a module with
``forward(batch, deterministic=True, teacher=None, generator=None) -> (B,
2, T_out)``, except the parameter-free constant-velocity predictor (a
function).  Submodules carry the Flax names, so
``convert.load_flax_params`` (and ``load_flax_batch_stats`` for STGCNN's
BatchNorm) carries the JAX package's weights across.
"""
from tsue_tpu_torch.models.baselines.cv import cv_candidates
from tsue_tpu_torch.models.baselines.gail import (GAILDiscriminator,
                                                  GAILGenerator)
from tsue_tpu_torch.models.baselines.lstm import CSLSTM, SocialLSTM
from tsue_tpu_torch.models.baselines.mmtrans import MMTrans
from tsue_tpu_torch.models.baselines.stgcnn import SocialSTGCNN
from tsue_tpu_torch.models.baselines.trajectron import TrajectronPP

BASELINE_REGISTRY = {
    "cs_lstm": CSLSTM,
    "social_lstm": SocialLSTM,
    "stgcnn": SocialSTGCNN,
    "trajectron": TrajectronPP,
    "mmtrans": MMTrans,
}
BASELINE_NAMES = ("cv",) + tuple(BASELINE_REGISTRY) + ("gail",)
