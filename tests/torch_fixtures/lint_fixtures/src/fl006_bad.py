"""flashlint fixture: FL006 — guarded field touched outside the lock."""


class LeakyEngine:
    _fl_guarded = ("state", "_staged_dirty")

    def __init__(self, dispatcher, state):
        self.dispatcher = dispatcher
        self.state = state                    # __init__: exempt
        self._staged_dirty = False

    def _lock(self):
        return self.dispatcher.lock

    def peek(self):
        return self.state                     # unlocked guarded read

    def snapshot(self):
        with self._lock():
            return self.state                 # correctly locked
