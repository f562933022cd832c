"""Model layers and blocks (the dense attention block of the serve slice)."""
