"""setup_s: seconds from the start of the process to the first timed call:
imports, the kernel build or its cache hit, traffic and weights, loading the
program, its graph capture and the warm-up of the cell's own shapes."""


def read(result):
    return result.setup_s
