from . import tecs_arena
from .engine import VectorEngine, VectorQueryTables
from .streaming import StreamingVectorEngine
from .tecs_arena import ArenaOverflow, ArenaSnapshot

__all__ = ["VectorEngine", "VectorQueryTables", "StreamingVectorEngine",
           "ArenaOverflow", "ArenaSnapshot", "tecs_arena"]
