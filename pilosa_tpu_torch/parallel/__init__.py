"""Stacked shard execution of the PyTorch port on one device."""
