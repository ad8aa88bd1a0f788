"""Utilities the PyTorch port's storage layer needs (copied from the JAX
package's ``utils/``)."""
