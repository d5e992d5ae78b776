"""Device ms a frame of kernel A (``trace_kernel``)."""


def read(s):
    ks = [k for k in s.kernels if k.own == "trace_kernel" and k.frame >= 0]
    return 1e3 * sum(k.dur_s for k in ks) / s.frames if ks else None
