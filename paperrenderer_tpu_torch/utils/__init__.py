from .logging import Logger, LogType
from .stats import StatisticsTracker, TimeStatisticInterval, Timer

__all__ = [
    "Logger", "LogType", "StatisticsTracker", "TimeStatisticInterval", "Timer",
]
