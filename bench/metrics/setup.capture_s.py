"""setup.capture_s: the benchmark's clock around the session's warm-up
(CUDA graph capture of the buckets the traffic uses)."""


def read(run):
    return run.capture_s
