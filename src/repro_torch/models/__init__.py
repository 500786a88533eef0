"""Model code: layers, attention, the dense decoder-only transformer."""
