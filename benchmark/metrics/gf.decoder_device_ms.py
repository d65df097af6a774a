"""Group-Free-3D's decoder's device time a request (models/groupfree.py):
the kernels launched inside the program's `detect.decoder` span (the two
projections, every layer's position embeddings, attention, feed-forward,
LayerNorms and head), by correlation id, over the profiled stretch's
requests."""

UNIT = "ms"
WORKLOADS = ["infer.groupfree_scannet_b8"]


def read(records):
    s = records.get("decoder_device_s")
    if not s:
        return None
    return 1e3 * s / records["traced_requests"]
