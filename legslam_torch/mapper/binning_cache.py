"""The mapper's tile-binning cache and its whole policy.

Counterpart of the cache logic inside legslam_tpu/mapper/mapper.py
(_cached, _get_binning and the trims of train_iteration). The
sort-dominated half of a step, the binning, depends only on geometry,
which drifts slowly between uses of one keyframe, so the mapper keeps a
binning per (keyframe, level) key:

  * refresh count: an entry is reused refresh_interval - 1 times, then
    filled again (refresh_interval 1 caches nothing: every step bins
    afresh, the reference's exact semantics);
  * an LRU of ENTRIES entries, ordered by use;
  * termination-aware trims (ops/binning.py trim_binning), flat layout on
    the "cuda" backend only: the refresh step emits the forward kernel's
    per-tile watermark (kfin), and the just-filled entry is trimmed at it
    for the reuse steps; the refresh step itself is pre-trimmed at the
    key's previous watermark with SLACK_CHUNKS chunks of headroom while
    that watermark's age is under MAX_AGE, and every (MAX_AGE + 1)-th
    refresh of a key runs untrimmed to re-measure in full (a kfin measured
    on a pre-trimmed binning is capped at the trim bound);
  * invalidation on store surgery and escalations, which drops both.

The watermarks live in a second dict, evicted by refresh where the
entries are evicted by use, as in JAX's mapper: one entry per key would
change which refreshes are pre-trimmed, and so the trained store. The
strip path's padded targets share the entries' LRU (`keep`), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from legslam_torch.config import RasterizeConfig
from legslam_torch.ops.binning import trim_binning

ENTRIES = 16
MAX_AGE = 3
SLACK_CHUNKS = 2


class BinningCache:
    def __init__(self, refresh_interval: int):
        self.refresh_interval = refresh_interval
        self.fills = 0        # binnings computed afresh
        self._entries: dict = {}      # key -> (uses left, value)
        self._watermarks: dict = {}   # key -> [age, kfin]

    def invalidate(self) -> None:
        self._entries.clear()
        self._watermarks.clear()

    def _lookup(self, key, fill: Callable[[], Any], uses: int):
        """The entry under `key`, moved to the LRU's young end, or
        fill()'s value cached for `uses` uses. Returns (value, filled)."""
        entry = self._entries.pop(key, None)
        if entry is not None and entry[0] > 0:
            uses_left, value = entry
            self._entries[key] = (uses_left - 1, value)
            return value, False
        value = fill()
        self._entries[key] = (uses - 1, value)
        while len(self._entries) > ENTRIES:
            self._entries.pop(next(iter(self._entries)))
        return value, True

    def keep(self, key, make: Callable[[], Any]):
        """make()'s value under `key` until invalidation or eviction."""
        return self._lookup(key, make, 1 << 30)[0]

    def get(self, key, fill: Callable[[], Any],
            cfg: Optional[RasterizeConfig] = None):
        """(binning, emit) for a step at `key`: the cached (Binning,
        overflow) pair, or None when nothing is cached (refresh_interval
        <= 1), and whether the step is to emit kfin for `trimmed`. Given
        the step's `cfg` (flat layout, "cuda" backend), a refresh emits
        and is pre-trimmed at the key's previous watermark while that is
        young enough."""
        if self.refresh_interval <= 1:
            return None, False
        binning, filled = self._lookup(key, fill, self.refresh_interval)
        self.fills += filled
        emit = filled and cfg is not None and cfg.backend == "cuda" and \
            cfg.n_buckets == 1
        if emit:
            mark = self._watermarks.get(key)
            if mark is not None and mark[0] < MAX_AGE:
                mark[0] += 1
                binning = (trim_binning(binning[0], mark[1], cfg.max_pairs,
                                        cfg.chunk,
                                        slack_chunks=SLACK_CHUNKS),
                           binning[1])
            else:
                self._watermarks.pop(key, None)
        return binning, emit

    def trimmed(self, key, binning, kfin, cfg: RasterizeConfig) -> None:
        """After an emitting step at `key` on `binning`: trim the cached
        entry at the step's watermark `kfin` for the reuse steps, and
        keep the watermark for the key's next refresh (its age stays
        where a pre-trim put it; a full re-measure re-enters at 0)."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries[key] = (entry[0], (trim_binning(
                binning[0], kfin, cfg.max_pairs, cfg.chunk), binning[1]))
        age = self._watermarks.get(key, [0, None])[0]
        self._watermarks[key] = [age, kfin]
        while len(self._watermarks) > ENTRIES:
            self._watermarks.pop(next(iter(self._watermarks)))
