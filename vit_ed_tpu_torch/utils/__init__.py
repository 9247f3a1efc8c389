from .logger import create_logger
from .misc import chunks, list_to_idx

__all__ = ["chunks", "create_logger", "list_to_idx"]
