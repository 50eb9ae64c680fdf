"""mc_block_roofline: K2's share of its roofline over the profiled part of
the window: the least time the card could take for every K2 launch's work
(yardstick.k2_work at the launch's dimensions, read at MC_BLOCK.launch;
the H100 SXM peaks of yardstick) over the launches' device time in the
trace."""

from yardstick import bound_s, k2_work

# MC_BLOCK.launch(ext, n_planes, hp, wp, sy, sx, fx, fy, out, n_fields,
#                 nby, nbx, n, taps, shift1, shift2, max, stream)
ARITY = 18


def read(rec):
    k = ((rec.get("trace") or {}).get("kernels") or {}).get("mc_block")
    if not k or not k["launches"] or len(k["launches"]) != len(k["seconds"]):
        return None
    if any(len(a) != ARITY for a in k["launches"]):
        return None
    least = sum(bound_s(*k2_work(a[1], a[2], a[3], a[9], a[10], a[11],
                                 a[12], a[13])) for a in k["launches"])
    return 100.0 * least / sum(k["seconds"])
