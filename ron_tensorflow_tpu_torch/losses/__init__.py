"""Detection losses (RON's; the SSD loss waits for the SSD slice)."""

from .ron import RonLossConfig, ron_losses

__all__ = ["RonLossConfig", "ron_losses"]
