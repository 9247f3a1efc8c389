from .wi19 import get_metrics

__all__ = ["get_metrics"]
