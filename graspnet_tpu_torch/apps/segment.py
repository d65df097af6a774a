"""Semantic segmentation of room scans: Point Transformer V3 on the port.

`SegmentationPipeline` holds the weights of `models/ptv3.py`'s `PTv3` on
the device and serves batches of grid-sampled fragments of different
lengths.  A fragment is (coord (n, 3), grid_coord (n, 3), feat (n,
in_channels)): its points, their integer cells (one point a cell, every
index in [0, 65535]) and their input channels (Pointcept's ScanNet
semantic segmentation: colour / 127.5 - 1 and the normal).  As
`DetectionPipeline`, it has a dispatch half, which enqueues everything on
the card and returns, and a blocking finish half:

  * `dispatch`: the cells and features to the card, then, in span
    `segment.serialize` (counts `points`, `sequences`: the attention
    sequences of every stage's patches), every stage's codes, orders,
    pooling clusters and patches, with one host read of each pooled
    stage's per-fragment counts; in span `segment.kmap` (count `pairs`,
    the maps' hits, joined at the fetch: they are the device's) the
    neighbour maps; then the forward and the labels (argmax) enqueued —
    all inside span `segment.dispatch`;
  * `finish`: the logits and labels to the host — span `segment.fetch`,
    whose first read waits for the device — and a `Segmentation` a
    fragment.

A `timings` dict gets the seconds of those spans by name, and `segment`,
the dispatch's start through the labels' arrival on the host.  Coordinates
are not read (the configuration has no relative position encoding).  Runs
on the card unless the caller asks for the CPU; matmuls in full float32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from graspnet_tpu_torch import checkpoint
from graspnet_tpu_torch.config import PTv3Config
from graspnet_tpu_torch.device import resolve_device
from graspnet_tpu_torch.models import init_weights
from graspnet_tpu_torch.models import ptv3
from graspnet_tpu_torch.ops.cuda.spconv import AXIS, MAX_BATCH
from graspnet_tpu_torch.utils.tracing import span


class Fragment(NamedTuple):
    coord: np.ndarray  # (n, 3) float
    grid_coord: np.ndarray  # (n, 3) int
    feat: np.ndarray  # (n, in_channels) float


@dataclasses.dataclass
class Segmentation:
    """One fragment's (n, num_classes) logits and (n,) labels (their argmax,
    the first maximum)."""

    logits: np.ndarray
    labels: np.ndarray


@dataclasses.dataclass
class SegmentationHandle:
    """What `dispatch` enqueued: the stages (points, orders, clusters,
    patches, maps), the stem's map, the maps' hits, the logits and labels
    on the device, the fragments' lengths, the `segment.kmap` span (its
    count comes at the fetch), the dispatch's start and the caller's
    timings."""

    stages: List[ptv3.Stage]
    stem: torch.Tensor
    hits: torch.Tensor
    logits: torch.Tensor
    labels: torch.Tensor
    counts: List[int]
    kmap_span: object
    start_ns: int
    timings: Optional[dict]


class SegmentationPipeline:
    """Holds the weights on the device, then serves batches of fragments."""

    def __init__(self, cfg: PTv3Config = PTv3Config(), params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device: str | torch.device = "cuda", checkpoint_path: Optional[str] = None):
        """`params`: the model's state dict; else `checkpoint_path`, a file
        of `checkpoint.save` holding one (or a training state whose 'model'
        it takes); else seeded random weights (`models.init_weights`)."""
        self.cfg = cfg
        self.device = resolve_device(device, "SegmentationPipeline")
        if params is None and checkpoint_path is not None:
            params = checkpoint.restore(checkpoint_path)
            params = params.get("model", params)
        model = ptv3.PTv3(cfg)
        if params is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _upload(self, fragments: Sequence):
        counts = [len(f[1]) for f in fragments]
        if not counts or min(counts) < 1 or len(counts) > MAX_BATCH:
            raise ValueError(f"a batch is 1 to {MAX_BATCH} fragments of at least one point")
        grid = np.concatenate([np.asarray(f[1]) for f in fragments]).astype(np.int32)
        feat = np.concatenate([np.asarray(f[2], np.float32) for f in fragments])
        lo, hi = int(grid.min()), int(grid.max())
        if lo < 0 or hi >= AXIS or grid.shape[1] != 3 or feat.shape != (grid.shape[0], self.cfg.in_channels):
            raise ValueError(f"fragments take (n, 3) cells in [0, {AXIS - 1}] and (n, {self.cfg.in_channels}) "
                             "features")
        grid_t = torch.from_numpy(grid).to(self.device)
        feat_t = torch.from_numpy(feat).to(self.device)
        batch = torch.repeat_interleave(torch.arange(len(counts), dtype=torch.int32, device=self.device),
                                        torch.tensor(counts, device=self.device), output_size=grid.shape[0])
        return grid_t, batch, feat_t, counts, ptv3.depth_of(hi)

    @torch.inference_mode()
    def dispatch(self, fragments: Sequence, timings: Optional[dict] = None) -> SegmentationHandle:
        """Enqueue a batch of fragments; the kernels run asynchronously on
        the current CUDA stream."""
        with span("segment.dispatch", into=timings) as d:
            grid, batch, feat, counts, depth = self._upload(fragments)
            with span("segment.serialize", into=timings, points=grid.shape[0]) as s:
                stages = ptv3.serialize(grid, batch, counts, depth, self.cfg)
                s.count(sequences=sum(st.patches.sequences for st in stages))
            with span("segment.kmap", into=timings) as k:
                stem, hits = ptv3.kernel_maps(stages, self.cfg)
            logits = self.model(feat, stages, stem)
            labels = torch.argmax(logits, dim=1)
        return SegmentationHandle(stages, stem, hits, logits, labels, counts, k, d.start_ns, timings)

    @torch.inference_mode()
    def finish(self, handle: SegmentationHandle) -> List[Segmentation]:
        """Blocking half: the logits and labels to the host (the wait on
        the device), a `Segmentation` a fragment."""
        with span("segment.fetch", into=handle.timings):
            logits = handle.logits.cpu().numpy()
            labels = handle.labels.cpu().numpy()
            pairs = int(handle.hits.item())
        if handle.timings is not None:
            handle.timings["segment"] = (time.perf_counter_ns() - handle.start_ns) * 1e-9
        handle.kmap_span.count(pairs=pairs)
        cuts = np.cumsum(handle.counts)[:-1]
        return [Segmentation(a, b) for a, b in zip(np.split(logits, cuts), np.split(labels, cuts))]

    def segment(self, fragments: Sequence, timings: Optional[dict] = None) -> List[Segmentation]:
        """A batch of fragments -> a `Segmentation` a fragment."""
        return self.finish(self.dispatch(fragments, timings))
