from .store import StateSnapshot, StateStore

__all__ = ["StateSnapshot", "StateStore"]
