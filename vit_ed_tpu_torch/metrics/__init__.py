from .map_prak import calc_map_prak
from .wi19 import get_metrics

__all__ = ["calc_map_prak", "get_metrics"]
