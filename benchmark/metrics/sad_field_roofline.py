"""sad_field_roofline: K1's share of its roofline over the profiled part
of the window: the least time the card could take for every K1 launch's
work (yardstick.k1_work at the launch's dimensions, read at
SAD_FIELD.launch; the H100 SXM peaks of yardstick) over the launches'
device time in the trace."""

from yardstick import bound_s, k1_work

# SAD_FIELD.launch(src, ref, out, h, w, n, r, stream)
ARITY = 8


def read(rec):
    k = ((rec.get("trace") or {}).get("kernels") or {}).get("sad_field")
    if not k or not k["launches"] or len(k["launches"]) != len(k["seconds"]):
        return None
    if any(len(a) != ARITY for a in k["launches"]):
        return None
    least = sum(bound_s(*k1_work(*a[3:7])) for a in k["launches"])
    return 100.0 * least / sum(k["seconds"])
