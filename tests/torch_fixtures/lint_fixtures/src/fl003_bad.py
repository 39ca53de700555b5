"""flashlint fixture: FL003 — a .state rebind with no invalidation,
plus the two Bloom-filter contract breaks."""


class ForgetfulBackend:
    def __init__(self, state, query_engine):
        self.state = state                    # first bind: exempt
        self.query_engine = query_engine

    def drain(self, new_state):
        self.state = new_state                # stale cache survives this


def rebuild_without_filters(old):
    # keyword rebuild that silently drops the filter arrays
    return DeviceTableState(
        keys=old.keys, counts=old.counts, log_keys=old.log_keys,
        log_counts=old.log_counts, log_ptr=old.log_ptr,
        ov_keys=old.ov_keys, ov_counts=old.ov_counts, ov_ptr=old.ov_ptr,
        stats=old.stats)


def merge_no_filter_maintenance(pair, old, perm, uk, uc):
    # device merge that skips the in-kernel filter maintenance
    return hops.merge_dirty(pair, old.keys, old.counts, perm, uk, uc)
