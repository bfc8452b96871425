from .population import SomPopulation
from .som import XPySom

__all__ = ["XPySom", "SomPopulation"]
