"""The tolerance generator: the port's `data/tolerance.py` and
`apps/generate_tolerance.py` against the JAX package's, on the CPU.

Tolerance labels are exact, so every comparison is bitwise: the port equals
the JAX `generate_tolerance` and the reference transcription
`tolerance_oracle` at the JAX test's size (P, V, A, D = 12, 4, 3, 2) and at
P = 64 with the full V*A*D = 300*12*4, with chunks of 8 and 256 and a
ragged last chunk; the radius scan stops where the reference stops, also
when a larger radius would pass again; the CLI writes the JAX CLI's files.
The loader's missing-file message names the port's generator.
"""

import sys

import numpy as np
import pytest
import torch

from graspnet_tpu.apps import generate_tolerance as jcli
from graspnet_tpu.data.tolerance import generate_tolerance as jax_generate
from graspnet_tpu.data.tolerance import tolerance_oracle as jax_oracle

from graspnet_tpu_torch.apps import generate_tolerance as cli
from graspnet_tpu_torch.data import dataset
from graspnet_tpu_torch.data.tolerance import RADIUS_LIST, generate_tolerance, tolerance_oracle


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def object_labels(rng, p, v, a, d, spread=0.02):
    """Label points of one object and friction scores with many exact
    thresholds: 0 (no grasp), mu itself, and values on both sides."""
    pts = rng.uniform(-spread, spread, (p, 3)).astype(np.float32)
    scores = rng.uniform(0.0, 1.2, (p, v, a, d)).astype(np.float32)
    pick = rng.uniform(size=scores.shape)
    scores[pick < 0.4] = 0.3
    scores[(pick >= 0.4) & (pick < 0.45)] = 0.55
    scores[(pick >= 0.45) & (pick < 0.5)] = 0.0
    return pts, scores


@pytest.mark.parametrize("p,v,a,d,chunks", [(12, 4, 3, 2, (8, 256, 5)), (64, 300, 12, 4, (8, 256, 24))],
                         ids=["jax_test_size", "full_cells"])
def test_equals_the_jax_generator_and_the_oracle(p, v, a, d, chunks):
    pts, scores = object_labels(np.random.default_rng(p), p, v, a, d)
    want = jax_generate(pts, scores, chunk=16)
    np.testing.assert_array_equal(want, jax_oracle(pts, scores))
    assert (want > 0).mean() > 0.2 and len(np.unique(want)) > 10  # radii of many sizes
    for chunk in chunks:  # 5 and 24 leave a ragged last chunk
        got = generate_tolerance(pts, scores, chunk=chunk, device="cpu")
        assert got.dtype == np.float32 and got.shape == scores.shape
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}")
    np.testing.assert_array_equal(tolerance_oracle(pts, scores), want)


def test_thresholds_are_arguments():
    pts, scores = object_labels(np.random.default_rng(3), 20, 5, 3, 2)
    for ratio, mu in ((0.5, 0.55), (0.8, 0.3), (1.0, 0.9)):
        np.testing.assert_array_equal(
            generate_tolerance(pts, scores, ratio, mu, device="cpu"),
            jax_generate(pts, scores, ratio, mu))


def test_the_scan_stops_at_the_first_radius_where_nothing_passes():
    """Point 0 sits alone within 1.5 mm, three bad points lie between 1.5
    and 2.5 mm, and many good ones from 3 mm: its ratio passes at 0-1 mm,
    fails at 2 mm (1 good of 4) and would pass again from ~15 mm on.  The
    reference stops at 2 mm, so the tolerance is 1 mm, not 50."""
    pts = [[0.0, 0.0, 0.0]]
    pts += [[0.002, 0.0, 0.0], [0.0, 0.002, 0.0], [0.0, 0.0, 0.002]]
    rng = np.random.default_rng(0)
    far = rng.normal(size=(60, 3))
    far = far / np.linalg.norm(far, axis=1, keepdims=True) * rng.uniform(0.003, 0.004, (60, 1))
    pts = np.concatenate([np.float32(pts), far.astype(np.float32)])
    scores = np.full((len(pts), 2, 1, 1), 0.3, np.float32)
    scores[1:4] = 0.0  # no grasp: not positive
    got = generate_tolerance(pts, scores, device="cpu")
    np.testing.assert_array_equal(got, jax_generate(pts, scores))
    np.testing.assert_array_equal(got, tolerance_oracle(pts, scores))
    assert got[0, 0, 0, 0] == np.float32(RADIUS_LIST[1])
    # without the stop, the largest passing radius would be the last
    ratio = []
    d = np.linalg.norm(pts - pts[0], axis=1)
    for r in RADIUS_LIST:
        ball = scores[d <= np.float32(r), 0, 0, 0]
        ratio.append(((ball > 0) & (ball <= 0.55)).mean())
    assert ratio[2] < 0.8 and ratio[-1] >= 0.8


def test_cli_writes_the_jax_clis_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    root = tmp_path / "ds"
    (root / "grasp_label").mkdir(parents=True)
    for i in (0, 2):
        pts, scores = object_labels(rng, 24, 6, 3, 2, spread=0.03)
        np.savez(root / "grasp_label" / f"{i:03d}_labels.npz", points=pts, scores=scores)
    assert cli.main(["--dataset_root", str(root), "--num_objects", "3", "--save_dir", str(tmp_path / "ours"),
                     "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["generate_tolerance", "--dataset_root", str(root), "--num_objects", "3",
                                      "--save_dir", str(tmp_path / "jax")])
    jcli.main()
    ours = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["000_tolerance.npy", "002_tolerance.npy"]
    for name in ours:
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / name), np.load(tmp_path / "jax" / name))
    # --objects picks ids, and the default output dir is {root}/tolerance
    assert cli.main(["--dataset_root", str(root), "--objects", "2", "--device", "cpu"]) == 0
    assert sorted(p.name for p in (root / "tolerance").iterdir()) == ["002_tolerance.npy"]


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    pts, scores = object_labels(np.random.default_rng(0), 4, 2, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_tolerance(pts, scores)


def test_loader_names_the_ports_generator(tmp_path):
    (tmp_path / "grasp_label").mkdir()
    np.savez(tmp_path / "grasp_label" / "000_labels.npz", points=np.zeros((1, 3), np.float32))
    with pytest.raises(FileNotFoundError) as err:
        dataset.load_grasp_labels(str(tmp_path), num_objects=1)
    msg = str(err.value)
    assert f"python -m graspnet_tpu_torch.apps.generate_tolerance --dataset_root {tmp_path}" in msg
    assert "graspnet_tpu.apps" not in msg
