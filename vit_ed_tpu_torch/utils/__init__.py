from .logger import create_logger
from .misc import AverageMeter, chunks, list_to_idx, set_seed

__all__ = ["AverageMeter", "chunks", "create_logger", "list_to_idx",
           "set_seed"]
