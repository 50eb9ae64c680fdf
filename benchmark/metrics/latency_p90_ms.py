"""latency_p90_ms: the 90th percentile (nearest rank) over every picture
pulled and yielded inside the window of the time from the encoder's pull
of its frame to the yield of its access unit."""

from yardstick import percentile


def read(rec):
    lat = rec["latencies_s"]
    return percentile(lat, 90) * 1e3 if lat else None
