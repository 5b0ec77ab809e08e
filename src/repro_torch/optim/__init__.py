from .adamw import AdamW, OptState, clip_by_global_norm, cosine_schedule

__all__ = ["AdamW", "OptState", "clip_by_global_norm", "cosine_schedule"]
