from .streams import NOISE_TYPES, StreamSpec, random_stream, stock_stream

__all__ = ["NOISE_TYPES", "StreamSpec", "random_stream", "stock_stream"]
