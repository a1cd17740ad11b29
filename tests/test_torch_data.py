"""The port's copy of the framework-neutral layer against the JAX package's
original: the configuration tree and presets, synthetic tracks, sliding
windows, the per-track text dataset and the tokenizer.  Everything is NumPy
or plain Python on both sides, so every array must be bit-identical.  The
JAX package may build windows through its C++ library; it documents that
path as bit-identical to the NumPy one, which is the port's only path."""
import dataclasses

import numpy as np
import pytest

from tsue_tpu import config as jax_config
from tsue_tpu import data as jax_data
from tsue_tpu.data.text_dataset import \
    build_track_text_dataset as jax_text_dataset
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch import data as port_data
from tsue_tpu_torch.data.text_dataset import build_track_text_dataset

CONFIG_CLASSES = ("DataConfig", "LlamaConfig", "QFormerConfig", "LTSFConfig",
                  "LaneEncoderConfig", "ModelConfig", "TrainConfig",
                  "MeshConfig", "ExperimentConfig")


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_class_defaults_equal(name):
    ours = getattr(port_config, name)()
    theirs = getattr(jax_config, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_presets_equal():
    assert sorted(port_config.PRESETS) == sorted(jax_config.PRESETS)
    for name in jax_config.PRESETS:
        assert dataclasses.asdict(port_config.get_preset(name)) == \
            dataclasses.asdict(jax_config.get_preset(name)), name
    assert dataclasses.asdict(port_config.LlamaConfig.tiny(384)) == \
        dataclasses.asdict(jax_config.LlamaConfig.tiny(384))


def _tracks(mod, **kw):
    return mod.make_synthetic_tracks(num_tracks=6, track_len=320, seed=3,
                                     anomaly_fraction=0.3, **kw)


def _assert_tracks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for key in x:
            if isinstance(x[key], np.ndarray):
                np.testing.assert_array_equal(x[key], y[key])
            else:
                assert x[key] == y[key], key


def test_synthetic_tracks_and_split_equal():
    ours, theirs = _tracks(port_data), _tracks(jax_data)
    _assert_tracks_equal(ours, theirs)
    for a, b in zip(port_data.split_tracks(ours, seed=42),
                    jax_data.split_tracks(theirs, seed=42)):
        _assert_tracks_equal(a, b)


@pytest.mark.parametrize("use_text", [True, False])
def test_build_windows_bit_identical(use_text):
    kw = dict(seq_len=6, out_len=6, stride=6, max_length=640,
              use_text=use_text)
    ours = port_data.build_windows(
        _tracks(port_data), port_config.DataConfig(**kw),
        port_data.ByteTokenizer() if use_text else None)
    theirs = jax_data.build_windows(
        _tracks(jax_data), jax_config.DataConfig(**kw),
        jax_data.ByteTokenizer() if use_text else None)
    assert len(ours) == len(theirs) > 0
    for field in dataclasses.fields(theirs):
        a, b = getattr(ours, field.name), getattr(theirs, field.name)
        assert a.dtype == b.dtype and a.shape == b.shape, field.name
        np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.mark.parametrize("require", [True, False])
def test_track_text_dataset_bit_identical(require):
    tracks = _tracks(port_data)
    tracks[1] = dict(tracks[1], context_str="")
    tracks[2] = dict(tracks[2], vision_embeddings=None)
    kw = dict(require_context=require, require_vision=require)
    ours = build_track_text_dataset(
        tracks, port_config.DataConfig(max_length=640),
        port_data.ByteTokenizer(), **kw)
    theirs = jax_text_dataset(
        tracks, jax_config.DataConfig(max_length=640),
        jax_data.ByteTokenizer(), **kw)
    assert len(ours) == len(theirs) == (4 if require else 6)
    for key, b in theirs.as_batch_dict().items():
        a = ours.as_batch_dict()[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert ours.reference_text == theirs.reference_text


@pytest.mark.parametrize("kw", [
    dict(shuffle=True),
    dict(shuffle=False, length_buckets=(256, 384, 640)),
    dict(shuffle=True, process_index=1, process_count=2),
    dict(shuffle=True, group_by_track=True, drop_remainder=True),
], ids=["shuffle", "buckets", "process_slice", "by_track"])
def test_batch_iterator_bit_identical(kw):
    """Seeded per-epoch shuffle, wrap-around padding with ``valid``, length
    buckets and the per-process slice, over two epochs."""
    data_cfg = dict(seq_len=6, out_len=6, stride=6, max_length=640)
    ours = port_data.build_windows(_tracks(port_data),
                                   port_config.DataConfig(**data_cfg),
                                   port_data.ByteTokenizer())
    theirs = jax_data.build_windows(_tracks(jax_data),
                                    jax_config.DataConfig(**data_cfg),
                                    jax_data.ByteTokenizer())
    for ds in (ours, theirs):           # rows of 200..400 tokens: buckets
        ds.attention_mask[200 + 7 * np.arange(len(ds))[:, None] % 200
                          <= np.arange(640)[None, :]] = 0
    a = port_data.BatchIterator(ours, 8, seed=5, **kw)
    b = jax_data.BatchIterator(theirs, 8, seed=5, **kw)
    assert len(a) == len(b) > 1
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        pairs = list(zip(a, b, strict=True))
        widths = {x["input_ids"].shape[1] for x, _ in pairs}
        assert widths == ({256, 384, 640} if "length_buckets" in kw
                          else {640})
        for x, y in pairs:
            assert sorted(x) == sorted(y)
            for key in y:
                assert x[key].dtype == y[key].dtype, key
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_tokenizer_round_trips():
    ours, theirs = port_data.get_tokenizer(), jax_data.get_tokenizer()
    assert (ours.vocab_size, ours.pad_id, ours.eos_id, ours.bos_id) == \
        (theirs.vocab_size, theirs.pad_id, theirs.eos_id, theirs.bos_id)
    text = "Lane A2, velocity 21.5 px/s — heading L2R. No right-following " \
           "vehicle. ünïcödé"
    ids = ours.encode(text, add_special_tokens=True, max_length=200)
    assert ids == theirs.encode(text, add_special_tokens=True,
                                max_length=200)
    assert ours.decode(ids) == theirs.decode(ids) == text
    junk = [0, 1, 2, 300, 383] + ids[:20]
    assert ours.decode(junk) == theirs.decode(junk)
    assert ours(text, max_length=7) == theirs(text, max_length=7)


def test_filters_equal():
    from tsue_tpu.data import filters as jf
    from tsue_tpu_torch.data import filters as tf
    for tr in _tracks(port_data):
        ctx = tr["context_str"]
        assert tf.filter_context(ctx) == jf.filter_context(ctx)
        assert tf.parse_lane_from_context(ctx) == \
            jf.parse_lane_from_context(ctx)
        lane = tf.parse_lane_from_context(ctx)
        if lane is not None:
            np.testing.assert_array_equal(
                tf.get_polygon_from_lane_roi(tr["lane_roi"], lane),
                jf.get_polygon_from_lane_roi(tr["lane_roi"], lane))
        raw = tr["raw_trajectory"][::5]
        direction = tf.filter_context(ctx)[1]
        assert tf.is_trajectory_abnormal(raw, lane_label=direction) == \
            jf.is_trajectory_abnormal(raw, lane_label=direction)
