from . import tecs_arena
from .engine import VectorEngine, VectorQueryTables
from .hits import HitList
from .multiquery import (MultiQueryEngine, Packing, build_packing,
                         check_packing_invariants)
from .partitioned import PartitionedStreamingEngine, PartitionStats
from .streaming import StreamingVectorEngine
from .tecs_arena import ArenaOverflow, ArenaSnapshot

__all__ = ["VectorEngine", "VectorQueryTables", "StreamingVectorEngine",
           "MultiQueryEngine", "Packing", "build_packing",
           "check_packing_invariants", "PartitionedStreamingEngine",
           "PartitionStats", "HitList", "ArenaOverflow", "ArenaSnapshot",
           "tecs_arena"]
