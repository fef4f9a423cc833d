"""Auxiliary subsystems: tracing, timing, structured logging.

The reference has none of these — only scattered prints (SURVEY.md §5).
"""

from text2video.utils.profiling import StageTimer, device_trace
from text2video.utils.logging import JsonLogger, get_logger

__all__ = ["StageTimer", "device_trace", "JsonLogger", "get_logger"]
