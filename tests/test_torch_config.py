"""The port's configuration (``legion_tpu_torch/config.py``) against the
reference's: JSON round trip, removed keys tolerated and unknown keys
rejected (after ``tests/test_config.py``), every JSON the reference's
``Config.to_json`` writes loading in the port equal field by field, the
same dataset registry, and no config field that nothing in the port
reads. Exact equality throughout."""

import dataclasses
import json
import pathlib

import pytest

from legion_tpu import config as jax_config
from legion_tpu_torch import config as port_config
from legion_tpu_torch.config import (CacheConfig, Config, DatasetConfig,
                                     ParallelConfig, SamplerConfig,
                                     TrainConfig)

SECTIONS = ("dataset", "sampler", "model", "train", "cache", "parallel")


def test_json_roundtrip():
    cfg = Config(sampler=SamplerConfig(fanouts=(5, 3), batch_size=64),
                 train=TrainConfig(learning_rate=0.01, epochs=7),
                 cache=CacheConfig(group_size=2),
                 parallel=ParallelConfig(num_devices=4))
    r = Config.from_json(cfg.to_json())
    assert r.sampler.fanouts == (5, 3)
    assert r.train.epochs == 7 and r.parallel.num_devices == 4
    assert r == cfg


def test_removed_keys_tolerated():
    s = ('{"sampler": {"batch_size": 32, "drop_last": true, '
         '"payload_bytes": 512}, "parallel": {"data_axis": "x"}, '
         '"train": {"scan_unroll": 8}}')
    cfg = Config.from_json(s)
    assert cfg.sampler.batch_size == 32
    assert not hasattr(cfg.train, "scan_unroll")


def test_unknown_key_rejected():
    with pytest.raises(ValueError, match="learning_rat"):
        Config.from_json('{"train": {"learning_rat": 0.0001}}')
    with pytest.raises(ValueError, match="fanout"):
        Config.from_json('{"sampler": {"fanout": [25, 10]}}')
    with pytest.raises(ValueError, match="halo_exchang"):
        Config.from_json('{"parallel": {"halo_exchang": "psum"}}')


def _every_section_set(cm):
    """A reference config with a non-default value in every field."""
    return cm.Config(
        dataset=cm.DatasetConfig(
            name="ogbn-products", path="/data/pr", num_nodes=11,
            num_edges=22, feature_dim=33, num_classes=44,
            feature_placement="hbm_sharded", topology_placement="host",
            feature_pad_align=64),
        sampler=cm.SamplerConfig(fanouts=(7, 5, 3), batch_size=96,
                                 eval_batch_size=48, observed_cap_slack=1.5,
                                 probe_caps=False, probe_caps_min_cap=7,
                                 probe_caps_batches=5, dedup_last=True),
        model=cm.ModelConfig(arch="lp_sage", hidden_dim=64, num_layers=3,
                             dropout=0.25, dtype="bfloat16"),
        train=cm.TrainConfig(learning_rate=0.1, epochs=3, seed=9,
                             pipeline_depth=4, checkpoint_dir="/ck",
                             checkpoint_every_steps=6, profile_dir="/prof"),
        cache=cm.CacheConfig(enabled=True, budget_bytes=12345, group_size=4,
                             cost_model_granularity=0.05,
                             presample_steps=8),
        parallel=cm.ParallelConfig(num_devices=8, halo_exchange="psum",
                                   halo_cap_slack=2.0,
                                   halo_probe_batches=3))


@pytest.mark.parametrize("which", ["default", "every_section_set"])
def test_reference_json_loads_equal_field_by_field(which):
    ref = (jax_config.Config() if which == "default"
           else _every_section_set(jax_config))
    got = Config.from_json(ref.to_json())
    for sec in SECTIONS:
        want = dataclasses.asdict(getattr(ref, sec))
        have = dataclasses.asdict(getattr(got, sec))
        if sec == "train":
            want.pop("scan_unroll")
        if sec == "model":
            # the port's own field (GAT's heads) loads at its default
            assert have.pop("num_heads") == 1
        assert have == want, sec
    # and the port writes the reference's JSON less the removed key
    ref_d = json.loads(ref.to_json())
    ref_d["train"].pop("scan_unroll")
    assert json.loads(got.to_json()) == ref_d
    # (ref leaves scan_unroll at its default, which the reference fills in)
    assert jax_config.Config.from_json(got.to_json()) == ref


def test_dataset_registry_matches_reference():
    assert set(port_config.DATASET_REGISTRY) == set(
        jax_config.DATASET_REGISTRY)
    for code, want in jax_config.DATASET_REGISTRY.items():
        got = port_config.DATASET_REGISTRY[code]
        assert isinstance(got, DatasetConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), code
        assert got.path is None


def test_no_dead_config_knobs():
    """Every config field is read somewhere in the port outside
    ``config.py`` (``tests/test_config.py::test_no_dead_config_knobs``
    over ``legion_tpu_torch/``): a knob nothing consumes silently lies to
    the user. Since the edge-partitioned driver reads the halo fields,
    there is no exception."""
    root = pathlib.Path(port_config.__file__).resolve().parent
    blob = "\n".join(p.read_text() for p in root.rglob("*.py")
                     if p.resolve() != pathlib.Path(
                         port_config.__file__).resolve())
    dead = [f"{cls.__name__}.{f.name}"
            for cls in (DatasetConfig, SamplerConfig, port_config.ModelConfig,
                        TrainConfig, CacheConfig, ParallelConfig, Config)
            for f in dataclasses.fields(cls) if f.name not in blob]
    assert dead == [], f"dead config knob(s), implement or delete: {dead}"
