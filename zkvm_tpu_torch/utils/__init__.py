"""Utilities: typed configuration and metrics/observability helpers."""

from .config import Config, get_config, set_config  # noqa: F401
from .metrics import Timer, MetricsRegistry, metrics  # noqa: F401
