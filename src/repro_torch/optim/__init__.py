"""The optimizer of the train step: AdamW with a cosine schedule and int8
gradient compression with error feedback, the reference's ``optim``
package on PyTorch."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                    global_norm)
from .compression import compress_gradients, decompress_gradients

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compress_gradients", "decompress_gradients"]
