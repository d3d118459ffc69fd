from .engine import DynamicBatcher, GenerationEngine

__all__ = ["DynamicBatcher", "GenerationEngine"]
