"""State checkpoints (heatx's ``.npz`` layout)."""
