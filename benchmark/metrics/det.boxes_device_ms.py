"""The box post-processing's device time a request (postproc/boxes.py):
the kernels launched inside the program's `detect.boxes` span (corners,
the empty-box count, the suppression matrix, the scores) and `detect.nms`
span (the NMS's sweeps), over the profiled stretch's requests."""

UNIT = "ms"
WORKLOADS = ["infer.votenet_scannet_b8"]


def read(records):
    s = records.get("boxes_device_s")
    if not s:
        return None
    return 1e3 * s / records["traced_requests"]
