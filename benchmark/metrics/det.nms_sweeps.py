"""The box NMS's Jacobi sweeps a request (postproc/nms.py::fixpoint, each
a host read of the device): the program's `detect.nms` span's count
`sweeps`, over the profiled stretch's requests."""

UNIT = "sweeps"
WORKLOADS = ["infer.votenet_scannet_b8"]


def read(records):
    sweeps = records.get("span_counts", {}).get("detect.nms", {}).get("sweeps")
    if sweeps is None:
        return None
    return sweeps / records["traced_requests"]
