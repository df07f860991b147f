"""legslam_torch/mapper/binning_cache.py alone: the mapper's binning cache
policy on stand-in binnings, with trim_binning replaced by a recorder.

* the refresh count: an entry serves refresh_interval steps, then refills;
  refresh_interval 1 caches nothing;
* the LRU: 16 entries, evicted by use; the strip path's kept targets take
  places in it;
* the watermark ratchet: a refresh on the flat "cuda" layout emits kfin,
  the cached entry is trimmed at it for the reuse steps, and the next
  refreshes are pre-trimmed at the previous watermark with 2 slack chunks
  until the watermark's age reaches 3: every 4th refresh re-measures
  untrimmed;
* invalidation drops the entries and the watermarks.
"""
import pytest

from legslam_torch.config import RasterizeConfig
from legslam_torch.mapper import binning_cache
from legslam_torch.mapper.binning_cache import BinningCache

CUDA = RasterizeConfig(backend="cuda", chunk=64, max_pairs=1 << 12)


@pytest.fixture
def trims(monkeypatch):
    """trim_binning's calls as (binning, kfin, slack_chunks); a trimmed
    binning is ("trimmed", binning, kfin)."""
    calls = []

    def trim(binning, kfin, max_pairs, chunk, slack_chunks=0):
        assert (max_pairs, chunk) == (CUDA.max_pairs, CUDA.chunk)
        calls.append((binning, kfin, slack_chunks))
        return ("trimmed", binning, kfin)
    monkeypatch.setattr(binning_cache, "trim_binning", trim)
    return calls


class Fills:
    """A fill function that hands out numbered (binning, overflow) pairs."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return (f"b{self.n}", 0)


def test_refresh_count():
    cache, fill = BinningCache(3), Fills()
    got = [cache.get("k", fill)[0][0] for _ in range(7)]
    assert got == ["b1", "b1", "b1", "b2", "b2", "b2", "b3"]
    assert cache.fills == fill.n == 3
    off = BinningCache(1)
    assert off.get("k", fill) == (None, False)
    assert off.fills == 0 and fill.n == 3


def test_lru_holds_16_entries_by_use():
    cache, fill = BinningCache(1 << 10), Fills()
    first = {k: cache.get(k, fill)[0] for k in range(16)}
    assert cache.get(0, fill)[0] == first[0]       # key 0 is used again
    cache.get(16, fill)                            # evicts key 1
    assert cache.fills == 17
    assert cache.get(0, fill)[0] == first[0]
    assert cache.get(1, fill)[0] != first[1]       # refilled
    assert cache.fills == 18
    # held now: 3..16, 0, 1 (1's refill evicted 2). Kept targets take a
    # place among the 16: they and six more keys evict 3..9
    t = cache.keep(("t",), lambda: "targets")
    for k in range(17, 23):
        cache.get(k, fill)
    assert cache.keep(("t",), lambda: "other") == t
    assert [cache.get(k, fill)[0] == first[k] for k in (10, 9)] == \
        [True, False]


def test_refresh_emits_only_on_the_flat_cuda_layout(trims):
    for cfg in (None, RasterizeConfig(backend="torch"),
                RasterizeConfig(backend="cuda", n_buckets=2)):
        cache, fill = BinningCache(2), Fills()
        assert [cache.get("k", fill, cfg)[1] for _ in range(4)] == \
            [False] * 4
    cache, fill = BinningCache(2), Fills()
    assert [cache.get("k", fill, CUDA)[1] for _ in range(4)] == \
        [True, False, True, False]
    assert trims == []      # no watermark was handed back


def test_watermark_ratchet(trims):
    """Refresh 1 runs untrimmed, 2-4 are pre-trimmed at the watermark of
    the refresh before, 5 re-measures untrimmed, and so on; every refresh
    trims its entry at its own watermark for the reuse step."""
    cache, fill = BinningCache(2), Fills()
    pre = []
    for r in range(1, 10):
        binning, emit = cache.get("k", fill, CUDA)
        assert emit
        n = len(trims)
        if binning[0][0] == "trimmed":
            _, raw, kfin = binning[0]
            assert raw == f"b{r}" and kfin == f"kfin{r - 1}"
            assert trims[-1] == (raw, kfin, binning_cache.SLACK_CHUNKS)
            pre.append(r)
        cache.trimmed("k", binning, f"kfin{r}", CUDA)
        assert len(trims) == n + 1 and trims[-1] == (binning[0], f"kfin{r}",
                                                     0)
        reuse, emit = cache.get("k", fill, CUDA)
        assert not emit and reuse == (("trimmed", binning[0], f"kfin{r}"),
                                      0)
    assert pre == [2, 3, 4, 6, 7, 8]
    assert cache.fills == 9 and binning_cache.MAX_AGE == 3


def test_watermarks_evicted_by_refresh(trims):
    """The entries are evicted by use, the watermarks by refresh: key 0,
    used at every step, keeps its entry but loses the oldest watermark;
    key 1 loses its entry but keeps its watermark."""
    cache, fill = BinningCache(18), Fills()
    for k in range(17):
        b, _ = cache.get(k, fill, CUDA)
        cache.trimmed(k, b, f"kfin{k}", CUDA)
        cache.get(0, fill, CUDA)
    assert cache.fills == 17
    n = len(trims)
    b0, emit = cache.get(0, fill, CUDA)     # key 0's refresh: untrimmed
    assert emit and b0 == ("b18", 0)
    b1, emit = cache.get(1, fill, CUDA)     # key 1's refill: pre-trimmed
    assert emit and b1 == (("trimmed", "b19", "kfin1"), 0)
    assert trims[n:] == [("b19", "kfin1", binning_cache.SLACK_CHUNKS)]


def test_invalidate(trims):
    cache, fill = BinningCache(4), Fills()
    b, emit = cache.get("k", fill, CUDA)
    cache.trimmed("k", b, "kfin1", CUDA)
    t = cache.keep(("t",), lambda: "targets")
    cache.invalidate()
    b2, emit2 = cache.get("k", fill, CUDA)
    assert emit and emit2 and b2 == ("b2", 0)      # refilled, untrimmed
    assert len(trims) == 1
    assert cache.keep(("t",), lambda: "again") == "again" != t
    assert cache.fills == 2
