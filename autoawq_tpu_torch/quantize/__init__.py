"""AWQ calibration: the scale and clip searches and their folding."""
