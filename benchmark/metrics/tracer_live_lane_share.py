"""The share of the lanes the cluster tracer sorts, pads and unsorts
that are live rays, over the profiled frames, in %: the port's counter
tracer.live_lanes (each tile_cluster_order's count of lanes whose window
is open) over tracer.lanes (each cluster.prepare's padded lane count)."""
from pbench import layers


def read(r):
    lay = layers.of(r)
    if lay is None or not lay.counters.get("tracer.lanes"):
        return None
    return 100.0 * lay.counters.get("tracer.live_lanes", 0) / lay.counters["tracer.lanes"]
