"""Per cent of the stretch's wall clock in which no kernel or copy ran."""


def read(s):
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
