"""Crash-only streaming and the ingestion service over the port's engines:
retries, heartbeats and stragglers (:mod:`.fault_tolerance`), the dynamic
query fleet (:mod:`.fleet`), checkpointed recovery with exactly-once
emission (:mod:`.recovery`), the resilient :class:`StreamService`
(:mod:`.service`) and the fault-tolerant LM :class:`Trainer`
(:mod:`.trainer`)."""
from .fault_tolerance import (HeartbeatMonitor, RetryPolicy, StepTimer,
                              run_with_retries)
from .fleet import CompileCache, QueryFleet
from .recovery import MatchLog, RecoveringStreamRunner, cumulative_matches
from .service import (DeadLetterQueue, EventValidator, Receipt,
                      ServiceMetrics, StreamService, StreamServiceError,
                      TokenBucket)
from .trainer import Trainer, TrainerConfig

__all__ = ["HeartbeatMonitor", "RetryPolicy", "StepTimer",
           "run_with_retries", "CompileCache", "QueryFleet",
           "MatchLog", "RecoveringStreamRunner", "cumulative_matches",
           "DeadLetterQueue", "EventValidator", "Receipt", "ServiceMetrics",
           "StreamService", "StreamServiceError", "TokenBucket", "Trainer",
           "TrainerConfig"]
