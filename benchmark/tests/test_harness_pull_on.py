"""The untimed pull after the window: it ends once every display index up
to the quality range's last has been yielded, also where decode order
runs ahead of display order."""

import pytest

import harness


def decode_order(hl, minigops):
    """Display indices in the decode order of a hierarchical-B stream:
    the IDR, then each mini-GOP's anchor before its B pictures."""
    gop = 1 << hl
    out = [0]

    def rec(a, b):
        if b - a >= 2:
            m = (a + b) // 2
            out.append(m)
            rec(a, m)
            rec(m, b)
    for k in range(minigops):
        out.append((k + 1) * gop)
        rec(k * gop, (k + 1) * gop)
    return out


def pulled(order, have, last):
    pictures = [{"idx": i} for i in order[:have]]
    rest = iter(order[have:])
    harness.pull_on(pictures, lambda: pictures.append({"idx": next(rest)}),
                    last)
    return [p["idx"] for p in pictures]


def test_decode_order_of_hl3():
    assert decode_order(3, 2) == [0, 8, 4, 2, 1, 3, 6, 5, 7,
                                  16, 12, 10, 9, 11, 14, 13, 15]


@pytest.mark.parametrize("have", range(0, 12))
def test_pull_on_stops_when_the_range_is_whole(have):
    order = decode_order(3, 2)
    last = 5                        # inside the first mini-GOP
    got = pulled(order, have, last)
    # every index up to last is there; the pull stopped at the first
    # access unit that made it so, or pulled nothing
    assert set(range(last + 1)) <= set(got)
    stop = max(order.index(i) for i in range(last + 1)) + 1
    assert len(got) == max(have, stop)


def test_pull_on_in_display_order_is_the_old_loop():
    order = list(range(40))
    for have in (1, 5, 30):
        got = pulled(order, have, 10)
        assert got == list(range(max(have, 11)))
