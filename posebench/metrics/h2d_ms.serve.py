"""Device milliseconds of host-to-device copies a request (the uint8
crops, their centres and scales)."""

PATTERN = r"Memcpy HtoD"


def read(s):
    t = s.copy_s(PATTERN)
    return 1e3 * t / s.iters if t > 0 else None
