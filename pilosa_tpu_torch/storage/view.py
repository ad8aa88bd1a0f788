"""View: a physical grouping of fragments inside a field (view.go:44-63).

Names: "standard", time views "standard_YYYY[MM[DD[HH]]]", and BSI views
"bsig_<field>".  A view owns one fragment per shard that has data.

Port copy of the JAX package's ``storage/view.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os

from ..core import VIEW_STANDARD
from .fragment import Fragment
from ..utils.locks import make_rlock


class View:
    def __init__(self, path: str | None, index: str, field: str, name: str,
                 max_op_n: int | None = None,
                 row_id_cap: int | None = None,
                 cache_type: str | None = None, cache_size: int = 0):
        """``cache_type``/``cache_size``: the owning field's rank-cache
        options (field.go cacheType/cacheSize), threaded down so the
        STANDARD view's fragments of a ranked/lru field get a RankCache
        attached.  Time and BSI views never cache — TopN pruning reads
        only the standard view (and BSI rows are bit slices, not rank
        candidates; the reference likewise forces CacheTypeNone on int
        fields)."""
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.max_op_n = max_op_n
        self.row_id_cap = row_id_cap
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.fragments: dict[int, Fragment] = {}
        self._lock = make_rlock("view")

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        """(view.go:263 CreateFragmentIfNotExists)"""
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag_path = None
                if self.path is not None:
                    frag_path = os.path.join(self.path, "fragments", str(shard))
                kwargs = {}
                if self.max_op_n is not None:
                    kwargs["max_op_n"] = self.max_op_n
                frag = Fragment(frag_path, self.index, self.field, self.name,
                                shard, row_id_cap=self.row_id_cap, **kwargs)
                # Only the STANDARD view caches: TopN candidate pruning
                # reads exclusively from it (cache/rank.topn_from_rank),
                # so rank maintenance on time/BSI views would be pure
                # write-path overhead with no reader.
                if self.cache_type in ("ranked", "lru") and \
                        self.name == VIEW_STANDARD:
                    from ..cache.rank import RankCache
                    frag.rank_cache = RankCache(self.cache_type,
                                                self.cache_size)
                self.fragments[shard] = frag
            return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def open(self):
        """Discover fragment files on disk (view.go openFragments)."""
        if self.path is None:
            return
        frag_dir = os.path.join(self.path, "fragments")
        if not os.path.isdir(frag_dir):
            return
        for name in os.listdir(frag_dir):
            if name.endswith(".wal"):
                name = name[:-4]
            try:
                shard = int(name)
            except ValueError:
                continue
            self.create_fragment_if_not_exists(shard)

    def close(self):
        with self._lock:
            for frag in self.fragments.values():
                frag.close()
