"""3D object detection in room scans: VoteNet and Group-Free-3D on the
port's PointNet++ path.

`DetectionPipeline` holds the weights of the model its configuration names
(a `VoteNetConfig`: `models/votenet.py`; a `GroupFreeConfig`:
`models/groupfree.py`, whose forward adds the spans `detect.kps` and
`detect.decoder`) on the device and serves batches of scans: (B,
num_point, 3 + 1) xyz and height above the floor
(votenet `scannet/scannet_detection_dataset.py`: z less the 0.99th
percentile of z, `floor_height`) -> each scan's kept boxes.  As
`GraspPipeline`, it has a dispatch half, which enqueues everything on the
card and returns at once, and a blocking finish half:

  * `dispatch`: the scans to the card, then the forward, the decode, the
    empty-box count and the NMS's suppression matrix enqueued
    (`postproc/boxes.py`) — span `detect.dispatch`, and inside it
    `detect.boxes` around the post-processing, with the count `card`
    (the empty-box count's kernel launches: 1 on the card, 0 on the CPU's
    plain route and where there are no boxes or no points); its counts
    `proposals`, `nonempty` and `kept` join it when the batch is fetched
    (they are the device's);
  * `finish`: the NMS's sweeps to the greedy result, whose first read
    waits for the device — span `detect.nms`, count `sweeps` — then the
    proposals' rows to the host — both in span `detect.fetch` — and a
    `Detections` a scan.

A `timings` dict gets the seconds of those spans by name, and `detect`,
the dispatch's start through the rows' arrival on the host.  Runs on the
card unless the caller asks for the CPU; matmuls in full float32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import GroupFreeConfig, VoteNetConfig
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import init_weights
from graspnet_tpu_torch.models.groupfree import GroupFree3D
from graspnet_tpu_torch.models.votenet import VoteNet
from graspnet_tpu_torch.ops.cuda.boxes import count_in_boxes
from graspnet_tpu_torch.postproc import boxes
from graspnet_tpu_torch.utils.tracing import span


def floor_height(xyz: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N, 4): xyz and the height above the floor, z less the
    0.99th percentile of z (scannet_detection_dataset.py:78-80)."""
    xyz = np.asarray(xyz, np.float32)
    floor = np.percentile(xyz[:, 2], 0.99)
    return np.concatenate([xyz, (xyz[:, 2] - floor)[:, None]], axis=1).astype(np.float32)


@dataclasses.dataclass
class Detections:
    """One scan's proposals after post-processing: `rows` (P, 12 +
    num_class), a row a proposal in `postproc/boxes.py`'s columns.  The
    reported boxes are the `kept` rows."""

    rows: np.ndarray

    @property
    def kept(self) -> np.ndarray:
        return self.rows[:, boxes.KEPT] > 0

    @property
    def nonempty(self) -> np.ndarray:
        return self.rows[:, boxes.NONEMPTY] > 0

    @property
    def index(self) -> np.ndarray:
        """The kept proposals' indices."""
        return np.flatnonzero(self.kept)

    @property
    def boxes(self) -> np.ndarray:
        """(M, 6): the kept boxes' lower then upper corners (depth coordinates)."""
        return self.rows[self.kept, boxes.LO: boxes.HI + 3]

    @property
    def obj_prob(self) -> np.ndarray:
        return self.rows[self.kept, boxes.OBJ_PROB]

    @property
    def sem_cls(self) -> np.ndarray:
        return self.rows[self.kept, boxes.SEM_CLS].astype(np.int64)

    @property
    def scores(self) -> np.ndarray:
        """(M, num_class): sem_prob x obj_prob a class (per_class_proposal)."""
        return self.rows[self.kept, boxes.SCORES:]


@dataclasses.dataclass
class DetectionHandle:
    """What `dispatch` enqueued: the device end points and rows, the NMS
    state `boxes.select` takes, the `detect.boxes` span (its counts come
    at the fetch), the dispatch's start and the caller's timings."""

    end_points: Dict[str, torch.Tensor]
    rows: torch.Tensor
    nms_state: tuple
    boxes_span: object
    start_ns: int
    timings: Optional[dict]


class DetectionPipeline:
    """Holds the weights on the device, then serves batches of scans."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 cfg: VoteNetConfig | GroupFreeConfig = VoteNetConfig(), seed: int = 0,
                 device: str | torch.device = "cuda", checkpoint_path: Optional[str] = None):
        """`cfg` names the model; `params`: its state dict; else
        `checkpoint_path`, a file of `checkpoint.save` holding one (or a
        training state whose 'model' it takes); else seeded random weights
        (`models.init_weights`)."""
        self.cfg = cfg
        self.device = resolve_device(device, "DetectionPipeline")
        if params is None and checkpoint_path is not None:
            params = checkpoint.restore(checkpoint_path)
            params = params.get("model", params)
        model = GroupFree3D(cfg) if isinstance(cfg, GroupFreeConfig) else VoteNet(cfg)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def warmup(self, batch_size: int = 1) -> float:
        """One batch of seeded random scans through the whole path (builds
        the kernels on first CUDA use); returns its wall time."""
        gen = torch.Generator().manual_seed(0)
        xyz = torch.rand((batch_size, self.cfg.num_point, 3), generator=gen) * torch.tensor([4.0, 4.0, 2.5])
        clouds = torch.cat([xyz, xyz[..., 2:3]], dim=-1)[..., : 3 + self.cfg.input_feature_dim]
        t0 = time.perf_counter()
        self.detect(clouds.numpy())
        return time.perf_counter() - t0

    @torch.inference_mode()
    def dispatch(self, clouds: np.ndarray, timings: Optional[dict] = None) -> DetectionHandle:
        """Enqueue a batch (B, num_point, 3 + input_feature_dim); the
        kernels run asynchronously on the current CUDA stream."""
        with span("detect.dispatch", into=timings) as d:
            x = torch.as_tensor(np.asarray(clouds, np.float32)).to(self.device)
            end_points = self.model(x)
            with span("detect.boxes", into=timings) as b:
                launched = count_in_boxes.launches
                rows, state = boxes.parse_predictions(end_points, x[..., :3], self.cfg, self.model.mean_size)
                b.count(card=count_in_boxes.launches - launched)
        return DetectionHandle(end_points, rows, state, b, d.start_ns, timings)

    @torch.inference_mode()
    def finish(self, handle: DetectionHandle) -> List[Detections]:
        """Blocking half: the NMS, the rows to the host (the wait on the
        device), a `Detections` a scan."""
        with span("detect.fetch", into=handle.timings):
            with span("detect.nms", into=handle.timings) as nms:
                rows, sweeps = boxes.select(handle.rows, handle.nms_state)
                nms.count(sweeps=sweeps)
            rows = rows.cpu().numpy()
        if handle.timings is not None:
            handle.timings["detect"] = (time.perf_counter_ns() - handle.start_ns) * 1e-9
        handle.boxes_span.count(proposals=rows.shape[0] * rows.shape[1],
                                nonempty=int((rows[..., boxes.NONEMPTY] > 0).sum()),
                                kept=int((rows[..., boxes.KEPT] > 0).sum()))
        return [Detections(r) for r in rows]

    def detect(self, clouds: np.ndarray, timings: Optional[dict] = None) -> List[Detections]:
        """(B, num_point, 3 + input_feature_dim) -> B `Detections`."""
        return self.finish(self.dispatch(clouds, timings))
