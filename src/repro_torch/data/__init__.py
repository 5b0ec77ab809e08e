from .pipeline import TokenDataset

__all__ = ["TokenDataset"]
