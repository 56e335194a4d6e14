"""Mean time a request waited in the server's queue, in ms: the server's
own stamps on the result, ``dequeue - submit``, over every request that
came back."""


def read(run):
    waits = [r["queue_wait"] * 1e3 for r in run.requests
             if r["ok"] and r["queue_wait"] is not None]
    return sum(waits) / len(waits) if waits else None
