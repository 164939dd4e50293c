"""Host milliseconds from a request's start to the return of its last
kernel launch (the profiler's runtime launch events), mean over the
traced requests."""


def read(s):
    if not s.enqueue_s:
        return None
    return 1e3 * sum(s.enqueue_s) / len(s.enqueue_s)
