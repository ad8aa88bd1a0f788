"""Caches of the PyTorch port: the per-fragment rank cache and the
generation-keyed result cache."""

from .rank import RankCache, iter_rank_caches, topn_from_rank  # noqa: F401
