from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         get_optimizer, global_norm, tree_leaves, tree_map,
                         tree_unflatten, warmup_cosine)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "get_optimizer", "global_norm", "tree_leaves", "tree_map",
           "tree_unflatten", "warmup_cosine"]
