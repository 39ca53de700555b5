"""Runtime pieces of the port: the WAL hand-off of a departed store."""
