"""The card's idle share in the measured window: 1 - (device busy
seconds an iteration, the union of kernel and copy intervals in the
traced segment) / (the untraced window's seconds an iteration). The
traced segment's own window is longer by the profiler's host cost; its
busy and window seconds are the result line's device.busy_s and
device.window_s."""


def read(s):
    if s.host_iters <= 0:
        return None
    return 100.0 * (1.0 - (s.busy_s / s.iters) / (s.host_s / s.host_iters))
