"""The port's own copy of the JAX package's framework-neutral data layer
(``tsue_tpu/data``): track schema, loading and synthetic tracks, context
filters, sliding windows, the batch iterator, the per-track text dataset
and the tokenizers.  NumPy only;
``tests/test_torch_data.py`` holds it bit-identical to the original."""
from tsue_tpu_torch.data.filters import (
    check_data_sanity,
    filter_context,
    parse_lane_from_context,
    get_polygon_from_lane_roi,
    is_trajectory_abnormal,
)
from tsue_tpu_torch.data.windowing import build_windows, WindowedDataset
from tsue_tpu_torch.data.tokenizer import ByteTokenizer, get_tokenizer
from tsue_tpu_torch.data.schema import (
    load_tracks,
    load_lane_roi,
    load_vendored_lane_roi,
    split_tracks,
    make_synthetic_tracks,
    make_synthetic_lane_roi,
)
from tsue_tpu_torch.data.text_dataset import (TrackTextDataset,
                                              build_track_text_dataset)
from tsue_tpu_torch.data.dataset import BatchIterator, pad_to_multiple
