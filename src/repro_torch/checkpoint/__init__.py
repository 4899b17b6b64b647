from .store import (AsyncCheckpointer, compress, decompress, default_codec,
                    latest_step, load_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "compress", "decompress", "default_codec",
           "latest_step", "load_checkpoint", "save_checkpoint"]
