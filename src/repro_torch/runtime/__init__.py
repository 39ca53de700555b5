"""Runtime pieces of the port: the resilient trainer (watchdog, NaN
rollback, checkpoint restart) and the WAL hand-off of a departed store."""
from .fault_tolerance import (NaNGuard, ResilientTrainer,  # noqa: F401
                              StepWatchdog, TrainerReport)
