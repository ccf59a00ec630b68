"""Detection losses: RON's (random negatives) and SSD's (hard negative mining)."""

from .ron import RonLossConfig, ron_losses
from .ssd import SsdLossConfig, ssd_losses

__all__ = ["RonLossConfig", "SsdLossConfig", "ron_losses", "ssd_losses"]
