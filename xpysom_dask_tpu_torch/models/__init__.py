from .som import XPySom

__all__ = ["XPySom"]
