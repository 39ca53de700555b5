"""flashlint fixture: FL004 — threading in a serving file that is not
the scheduler (only ``serving/scheduler.py``'s trace-replay feeders may
spawn workers)."""
import threading


def rogue_feeder(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t
