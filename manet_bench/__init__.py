"""The MANet port's benchmark harness."""
