"""The lane-ROI polygon map: ``python -m tsue_tpu_torch.cli roi_map
[--roi TABLE|synthetic] [--site S] [--zone Z] [--out NAME] [--out-dir
DIR]`` (the port's ``scripts/graph.py``; ref scripts/graph.py:218-251).

The ROI comes from --roi, else --data's tracks, else the vendored Site-C
table (``_common.resolve_roi``).  Prints {"map": path} as one JSON line.
"""
from __future__ import annotations

from tsue_tpu_torch.cli._common import (add_roi_args, base_parser, finish,
                                        resolve_roi)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--out", default="lane_roi_map.png")
    add_roi_args(p)
    args = p.parse_args(argv)
    from tsue_tpu_torch.viz.plots import plot_lane_roi_map
    path = plot_lane_roi_map(resolve_roi(args), args.out_dir,
                             site=args.site, zone=args.zone, name=args.out)
    return finish({"map": path})


if __name__ == "__main__":
    main()
