"""flashlint fixture: FL002 — reading a state after a call consumed it
in place (``table_torch.update`` / ``flush`` rewrite its tensors and
return the successor)."""
from repro_torch.core import distributed as D
from repro_torch.core import table_torch as tt


def drain_once(cfg, state, toks):
    new_state = tt.update(cfg, state, toks)   # consumes ``state``
    stale = state.keys                        # read of the consumed state
    return new_state, stale


def merge_then_peek(cfg, state):
    merged = tt.flush(cfg, state)             # consumes ``state``
    return merged, state.log_ptr              # read of the consumed state


def sharded_wave(cfg, group, states, toks, dels):
    new, _ = D.update(cfg, group, states, toks, dels)  # consumes ``states``
    return new, states[0]                     # read of the consumed states


def drain_rebound(cfg, state, toks):
    state = tt.update(cfg, state, toks)       # rebound: the contract
    state = tt.flush(cfg, state)
    return state.keys
