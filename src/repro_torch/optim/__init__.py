from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                    cosine_lr, global_norm)
from .compression import (compressed_allreduce_demo, ef_compress_grads,
                          ef_compress_grads_, ef_init)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "cosine_lr", "global_norm", "compressed_allreduce_demo",
           "ef_compress_grads", "ef_compress_grads_", "ef_init"]
