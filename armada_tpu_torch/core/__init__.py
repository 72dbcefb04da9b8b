from .resources import ResourceListFactory, parse_quantity
from .priorities import PriorityClass, EVICTED_PRIORITY
from .config import SchedulingConfig, PoolConfig, ResourceType

__all__ = [
    "ResourceListFactory",
    "parse_quantity",
    "PriorityClass",
    "EVICTED_PRIORITY",
    "SchedulingConfig",
    "PoolConfig",
    "ResourceType",
]
