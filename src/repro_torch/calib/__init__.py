"""Static activation calibration: observers, policy and the calibration pass."""
