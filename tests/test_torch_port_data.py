"""The port's `data/` against the JAX package's, bitwise.

* `GraspNetDataset.get_data_label` on the on-disk mini dataset
  (`tests/mini_dataset.py`), in both label modes, across two epochs: every
  array of every sample equal in dtype and value, and in the compact mode
  every field of the indexed label context.
* `SyntheticGraspNetDataset` likewise, and the `DataLoader`'s epoch-pinned
  shuffle and collation.
* An indexed-context `step_prepared` on the synthetic data is bitwise the
  full-label step on the same frames (the JAX package's claim for its
  compact path, `tests/test_labels.py:227`).
"""

import numpy as np
import pytest
import torch

from graspnet_tpu.config import GraspNetConfig as JConfig
from graspnet_tpu.data import dataset as jdataset
from graspnet_tpu.data.synthetic import SyntheticGraspNetDataset as JSynthetic

from graspnet_tpu_torch.config import GraspNetConfig
from graspnet_tpu_torch.data import dataset as pdataset
from graspnet_tpu_torch.data.synthetic import SyntheticGraspNetDataset
from graspnet_tpu_torch.train import label_pipeline as lp
from graspnet_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.mini_dataset import make_mini_dataset

CFG, JCFG = GraspNetConfig.tiny(), JConfig.tiny()
SYNTH = dict(n_frames=4, n_objects=3, label_points=40, cloud_points=1500, num_points=CFG.num_point)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_graspnet")), num_view=60)


def assert_same(got, want, where="sample"):
    """Equal structure, dtypes and values; label contexts field by field."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif hasattr(want, "__slots__"):
        assert type(got).__name__ == type(want).__name__, where
        for k in want.__slots__:
            assert_same(getattr(got, k), getattr(want, k), f"{where}.{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=where)


def pair(root, mode, split="train"):
    jv, jl = jdataset.load_grasp_labels(root, num_objects=3)
    pv, pl = pdataset.load_grasp_labels(root, num_objects=3)
    common = dict(camera="realsense", split=split, num_points=CFG.num_point, remove_outlier=True,
                  augment=split == "train", label_mode=mode)
    return (pdataset.GraspNetDataset(root, pv, pl, cfg=CFG, **common),
            jdataset.GraspNetDataset(root, jv, jl, cfg=JCFG, **common))


@pytest.mark.parametrize("mode", ["compact", "full"])
def test_get_data_label_matches_jax_over_two_epochs(root, mode):
    port, jax_ds = pair(root, mode)
    assert len(port) == len(jax_ds) == 2
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            got = port.get_data_label(i)
            assert_same(got, jax_ds.get_data_label(i), f"epoch {epoch} frame {i}")
            if mode == "compact":
                assert isinstance(got["label_ctx"], lp.IndexedSceneLabelContext)


def test_get_data_and_raw_cloud_match_jax(root):
    port, jax_ds = pair(root, "compact", split="test_seen")
    for i in range(len(port)):
        assert_same(port.get_data(i), jax_ds.get_data(i))
        assert_same(port.get_raw_cloud(i), jax_ds.get_raw_cloud(i))


@pytest.mark.parametrize("mode", ["compact", "full"])
def test_synthetic_matches_jax_over_two_epochs(mode):
    port = SyntheticGraspNetDataset(cfg=CFG, label_mode=mode, **SYNTH)
    jax_ds = JSynthetic(cfg=JCFG, label_mode=mode, **SYNTH)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in (0, 3):
            assert_same(port.get_data_label(i), jax_ds.get_data_label(i), f"epoch {epoch} frame {i}")


def test_loader_batches_match_jax():
    """Epoch-pinned shuffles, worker threads and collation: the same batches
    in the same order as the JAX loader's."""
    port = SyntheticGraspNetDataset(cfg=CFG, **SYNTH)
    jax_ds = JSynthetic(cfg=JCFG, **SYNTH)
    for epoch in (0, 1):
        batches = []
        for ds, mod in ((port, pdataset), (jax_ds, jdataset)):
            ds.set_epoch(epoch)
            loader = mod.DataLoader(ds, 2, shuffle=True, num_workers=3)
            loader.set_epoch(epoch)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) == 2
        assert_same(batches[0], batches[1], f"epoch {epoch}")


def test_indexed_compact_step_equals_full_step_bitwise():
    """The dataset's indexed compact labels, through prepare /
    step_prepared, give the full-label step's loss, metrics and parameters
    bit for bit."""
    compact = SyntheticGraspNetDataset(cfg=CFG, label_mode="compact", **SYNTH)
    full = SyntheticGraspNetDataset(cfg=CFG, label_mode="full", **SYNTH)
    cb = pdataset.collate([compact.get_data_label(i) for i in (0, 1)])
    fb = pdataset.collate([full.get_data_label(i) for i in (0, 1)])
    np.testing.assert_array_equal(cb["point_clouds"], fb["point_clouds"])
    a = Trainer(CFG, TrainConfig(), seed=0, device="cpu")
    b = Trainer(CFG, TrainConfig(), seed=0, device="cpu")
    for _ in range(2):
        la, ma = a.step(fb)
        lb, mb = b.step_prepared(b.prepare(cb))
        assert float(la) == float(lb)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
