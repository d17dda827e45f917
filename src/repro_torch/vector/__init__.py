from .engine import VectorEngine, VectorQueryTables
from .streaming import StreamingVectorEngine

__all__ = ["VectorEngine", "VectorQueryTables", "StreamingVectorEngine"]
