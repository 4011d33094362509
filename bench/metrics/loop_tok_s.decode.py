"""Generated tokens of the window's untraced decode steps over their host
seconds: the rate of the host's decode loop, read in a traced run without
the profiler's part. A per-layer reading where that rate swings with the
host CPU's speed too widely to hold a bound end to end."""


def read(r):
    if not r.untraced or not r.untraced_s > 0:
        return None
    return sum(len(lengths) for lengths in r.untraced) / r.untraced_s
