"""Constants, 3x3 algebra and compensated sums."""
