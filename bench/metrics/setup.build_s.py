"""setup.build_s: the benchmark's clock around ``build_index``,
synchronised (train, assign, encode, layout)."""


def read(run):
    return run.build_s
