"""setup_s: the host clock from the process's start to the window's."""


def read(run):
    return run.setup_s
