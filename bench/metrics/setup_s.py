"""setup_s: seconds from the start of the process to the window's start
(imports, data, the build, graph capture, warm traffic)."""


def read(run):
    return run.setup_s
