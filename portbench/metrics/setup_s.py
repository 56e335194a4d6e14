"""Seconds from the process's start to the window's start: drawing the
weights, building the session, the warm generation at the cell's shape
(and on a checkout's first run, building the kernel library), starting
the server and the clients."""


def read(run):
    return run.setup_s
