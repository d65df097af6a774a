"""Grasp containers: the 17-float row contract.

Counterpart of `graspnet_tpu/postproc/grasp.py`, without the mesh and
open3d methods (they wait for the visualisation slice).  Row layout:

    [0]     score
    [1]     width
    [2]     height
    [3]     depth
    [4:13]  rotation matrix, row-major
    [13:16] translation (grasp center)
    [16]    object id
"""

from __future__ import annotations

import numpy as np

from graspnet_tpu_torch.postproc.nms import grasp_nms

GRASP_ARRAY_LEN = 17


class Grasp:
    """A single grasp (one 17-float row)."""

    def __init__(self, array: np.ndarray):
        array = np.asarray(array, dtype=np.float32).reshape(-1)
        if array.shape != (GRASP_ARRAY_LEN,):
            raise ValueError(f"a grasp row has {GRASP_ARRAY_LEN} floats, got {array.shape}")
        self.grasp_array = array

    def _field(i):  # noqa: N805 — descriptor factory, not a method
        def get(self):
            return float(self.grasp_array[i])

        def set_(self, v):
            self.grasp_array[i] = v

        return property(get, set_)

    score = _field(0)
    width = _field(1)
    height = _field(2)
    depth = _field(3)
    del _field

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.grasp_array[4:13].reshape(3, 3)

    @rotation_matrix.setter
    def rotation_matrix(self, R):
        self.grasp_array[4:13] = np.asarray(R, np.float32).reshape(9)

    @property
    def translation(self) -> np.ndarray:
        return self.grasp_array[13:16]

    @translation.setter
    def translation(self, t):
        self.grasp_array[13:16] = np.asarray(t, np.float32).reshape(3)

    @property
    def object_id(self) -> int:
        return int(self.grasp_array[16])

    @object_id.setter
    def object_id(self, v):
        self.grasp_array[16] = v

    def to_matrix(self) -> np.ndarray:
        """4x4 pose (rotation + translation)."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.rotation_matrix
        T[:3, 3] = self.translation
        return T

    def transform(self, T: np.ndarray) -> "Grasp":
        """Apply a 4x4 rigid transform in place; returns self."""
        T = np.asarray(T, np.float32)
        self.translation = T[:3, :3] @ self.translation + T[:3, 3]
        self.rotation_matrix = T[:3, :3] @ self.rotation_matrix
        return self

    def __repr__(self):
        return (
            f"Grasp(score={self.score:.4f}, width={self.width:.4f}, "
            f"depth={self.depth:.4f}, t={self.translation})"
        )


class GraspGroup:
    """A set of grasps backed by an (M, 17) float32 array."""

    def __init__(self, grasp_group_array: np.ndarray | None = None):
        if grasp_group_array is None:
            grasp_group_array = np.zeros((0, GRASP_ARRAY_LEN), dtype=np.float32)
        arr = np.asarray(grasp_group_array, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != GRASP_ARRAY_LEN:
            raise ValueError(f"a grasp group is (M, {GRASP_ARRAY_LEN}), got {arr.shape}")
        self.grasp_group_array = arr

    def __len__(self):
        return len(self.grasp_group_array)

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            return Grasp(self.grasp_group_array[index])
        return GraspGroup(self.grasp_group_array[index])

    def __repr__(self):
        return f"GraspGroup(n={len(self)})"

    scores = property(lambda self: self.grasp_group_array[:, 0])
    widths = property(lambda self: self.grasp_group_array[:, 1])
    heights = property(lambda self: self.grasp_group_array[:, 2])
    depths = property(lambda self: self.grasp_group_array[:, 3])
    object_ids = property(lambda self: self.grasp_group_array[:, 16])

    @property
    def rotation_matrices(self) -> np.ndarray:
        return self.grasp_group_array[:, 4:13].reshape(-1, 3, 3)

    @property
    def translations(self) -> np.ndarray:
        return self.grasp_group_array[:, 13:16]

    def add(self, other: "GraspGroup") -> "GraspGroup":
        return GraspGroup(
            np.concatenate([self.grasp_group_array, other.grasp_group_array], axis=0)
        )

    def sort_by_score(self, reverse: bool = False) -> "GraspGroup":
        """Descending by default (graspnetAPI convention)."""
        order = np.argsort(-self.grasp_group_array[:, 0], kind="stable")
        if reverse:
            order = order[::-1]
        return GraspGroup(self.grasp_group_array[order])

    def random_sample(self, numGrasp: int, rng: np.random.Generator | None = None) -> "GraspGroup":
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(self), min(numGrasp, len(self)), replace=False)
        return GraspGroup(self.grasp_group_array[idx])

    def remove(self, index) -> "GraspGroup":
        """Drop the grasp(s) at `index` in place (graspnetAPI semantics)."""
        self.grasp_group_array = np.delete(self.grasp_group_array, index, axis=0)
        return self

    def transform(self, T: np.ndarray) -> "GraspGroup":
        """Apply a 4x4 rigid transform to every grasp in place."""
        T = np.asarray(T, np.float32)
        arr = self.grasp_group_array
        arr[:, 13:16] = arr[:, 13:16] @ T[:3, :3].T + T[:3, 3]
        rots = T[:3, :3][None] @ arr[:, 4:13].reshape(-1, 3, 3)
        arr[:, 4:13] = rots.reshape(-1, 9)
        return self

    def nms(self, translation_thresh: float = 0.03, rotation_thresh: float = 30.0 / 180.0 * np.pi) -> "GraspGroup":
        """Greedy pose NMS (graspnetAPI GraspGroup.nms semantics)."""
        keep = grasp_nms(self.grasp_group_array, translation_thresh, rotation_thresh)
        return GraspGroup(self.grasp_group_array[keep])

    def save_npy(self, path: str) -> None:
        np.save(path, self.grasp_group_array)

    @staticmethod
    def from_npy(path: str) -> "GraspGroup":
        return GraspGroup(np.load(path))
