from .logging import Logger, LogType
from .stats import StatisticsTracker, TimeStatisticInterval, Timer
from .profiling import device_time, trace

__all__ = [
    "Logger", "LogType", "StatisticsTracker", "TimeStatisticInterval", "Timer",
    "device_time", "trace",
]
