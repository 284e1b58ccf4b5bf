"""setup_s: seconds from the process's start to the first timed request."""


def read(suffix, run):
    return run.setup_s
