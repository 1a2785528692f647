from .trainer import HeartbeatMonitor, Trainer, TrainerConfig

__all__ = ["HeartbeatMonitor", "Trainer", "TrainerConfig"]
