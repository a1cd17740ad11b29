"""Helpers: randomness from explicit generators, seeding and metric
logging."""
from tsue_tpu_torch.utils.logging import MetricLogger, seed_everything
