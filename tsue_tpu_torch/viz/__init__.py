"""Plots of trajectories, candidates and lane maps (matplotlib, imported
at the first plot)."""
from tsue_tpu_torch.viz.plots import (
    plot_one_sample, plot_candidates, plot_best_of_k, plot_xy_time,
    plot_lane_roi_map, plot_trajectories_over_map)
