"""Serving engine: the paper's scheduler driving the port's model."""

from .engine import Endpoint, ServingEngine
from .kvcache import SlotPool

__all__ = ["Endpoint", "ServingEngine", "SlotPool"]
