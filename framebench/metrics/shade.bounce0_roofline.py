"""Kernel B's share of its least time on each frame's first launch
(bounce 0, W x H lanes): ``roofline.Yardsticks.shade_bound_s`` over the
mean device time of those launches, in per cent."""


def read(s):
    firsts = s.first_per_frame("shade_kernel")
    if not firsts:
        return None
    mean = sum(k.dur_s for k in firsts) / len(firsts)
    return 100.0 * s.yard.shade_bound_s() / mean
