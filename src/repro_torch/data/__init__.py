from .streams import NOISE_TYPES, StreamSpec, random_stream, stock_stream
from .tokens import TokenPipeline, TokenPipelineState

__all__ = ["NOISE_TYPES", "StreamSpec", "random_stream", "stock_stream",
           "TokenPipeline", "TokenPipelineState"]
