"""Point Transformer V3's serialization and neighbour maps on the device,
a request: the kernels launched inside the program's `segment.serialize`
span (the four orders' codes, sorts and inverses, the pooling clusters,
the patches) and `segment.kmap` span (the six maps), by correlation id,
over the profiled stretch's requests."""

UNIT = "ms"
WORKLOADS = ["infer.ptv3_scannet_b4"]


def read(records):
    s = records.get("serialize_device_s")
    if not s:
        return None
    return 1e3 * s / records["traced_requests"]
