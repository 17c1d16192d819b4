"""The frozen metric arithmetic on synthetic traces."""
import pytest

from pbench import stats, trace


def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4)]
    assert stats.union_seconds(iv) == pytest.approx(2.5)
    assert stats.union_seconds(iv, 0.25, 2.5) == pytest.approx(1.75)


def test_union_of_nested_and_touching():
    assert stats.union_seconds([(0, 4), (1, 2), (4, 5)]) == pytest.approx(5)
    assert stats.union_seconds([]) == 0.0


def test_gaps_complement_the_union():
    iv = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0)]
    g = stats.gaps(iv, 0.0, 6.0)
    assert g == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    assert sum(e - s for s, e in g) + stats.union_seconds(iv, 0.0, 6.0) == pytest.approx(6.0)


def test_p90_is_over_every_frame():
    times = [0.1] * 90 + [1.0] * 10
    assert stats.percentile(times, 90) == 0.1
    assert stats.percentile(times + [2.0], 90) == 1.0
    assert stats.percentile(list(range(1, 101)), 90) == 90


def test_window_over_frames():
    assert stats.per_item_ms(30.0, 100) == pytest.approx(300.0)


def _trace():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("Memcpy HtoD", 2.0, 2.5), ("k1", 3.0, 4.0)]
    host = [("bench:frame", 0.0, 5.0), ("aten::nonzero", 1.5, 2.0),
            ("cudaStreamSynchronize", 2.5, 3.0)]
    return trace.Trace(dev, host, {"frame": [(0.0, 5.0)]})


def test_busy_share_from_the_union():
    tr = _trace()
    assert trace.busy_seconds(tr, *tr.window("frame")) == pytest.approx(3.0)
    assert [k[0] for k in tr.kernels()] == ["k1", "k2", "k1"]


def test_breakdown_names_ops_and_gaps():
    tr = _trace()
    top = trace.top_device_ops(tr, 0.0, 5.0)
    assert top[0] == ["k1", 2.0]
    g = trace.idle_gaps(tr, 0.0, 5.0)
    assert g[0] == ["frame", pytest.approx(1.0)]
    assert ["frame > aten::nonzero", pytest.approx(0.5)] in g
    assert ["frame > cudaStreamSynchronize", pytest.approx(0.5)] in g
