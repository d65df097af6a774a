"""AP evaluation: native re-implementation of the graspnetAPI evaluator
(a copy of `graspnet_tpu/eval/`, numpy and the host library).

The reference depends on the external `graspnetAPI` package for
`GraspNetEval.eval_all` (reference test.py:110-114); its vendored copy is
empty, so this framework ships its own re-derivation of the published
GraspNet-1Billion protocol: NMS -> per-object top-10 -> global top-50 cut
-> binary gripper-volume collision + empty-jaw rejection -> dexnet-style
force-closure scoring (minimal passing friction mu*) -> Precision@k over
k=1..50 and mu in {0.2,...,1.2}.  See eval/ap.py for the stage-by-stage
derivation notes.
"""

from graspnet_tpu_torch.eval.force_closure import (
    FRICTIONS,
    antipodal_contacts,
    estimate_normals,
    force_closure_2pt,
    min_friction,
)
from graspnet_tpu_torch.eval.ap import (
    GraspNetEval,
    accuracy_matrix,
    collision_and_empty,
    eval_frame,
    summarize,
)

__all__ = [
    "GraspNetEval",
    "FRICTIONS",
    "accuracy_matrix",
    "antipodal_contacts",
    "collision_and_empty",
    "estimate_normals",
    "eval_frame",
    "force_closure_2pt",
    "min_friction",
    "summarize",
]
