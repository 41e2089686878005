"""95th percentile (nearest rank) over every batch of the window of one
batch's latency, from the call until its results are ready, read by CUDA
events on the card's clock."""

import math


def read(rec):
    lat = sorted(rec.latencies_ms)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
