"""Stacked shard execution of the PyTorch port over a list of devices."""
