"""Kernel A's share of its least time on each frame's first launch (the
W x H primaries): ``roofline.Yardsticks.primary_bound_s`` over the mean
device time of those launches, in per cent."""


def read(s):
    firsts = s.first_per_frame("trace_kernel")
    if not firsts:
        return None
    mean = sum(k.dur_s for k in firsts) / len(firsts)
    return 100.0 * s.yard.primary_bound_s() / mean
