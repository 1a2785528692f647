from .steps import make_train_step

__all__ = ["make_train_step"]
