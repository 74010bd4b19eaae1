"""The readers of the port's span counters: the median over the window's
calls of one ``pipeline_cache`` key, and None where there is nothing to
read."""

import pytest

from pmdbench import catalog

READERS = {"host_read_s": "stats.host_read_s", "slot_wait_s": "stats.slot_wait_s",
           "chunk_wait_s": "stats.chunk_wait_s", "vreg_layout_s": "vreg.layout_s"}


def _run(values, key):
    return dict(calls=[dict(wall_s=1.0, cache={key: v, "stream_dtype": "uint16"})
                       for v in values])


@pytest.mark.parametrize("metric,key", list(READERS.items()))
def test_reader_is_the_median_over_the_calls(metric, key):
    read = catalog.reader(metric)
    assert read(_run([0.5, 0.1, 0.3], key)) == pytest.approx(0.3)
    assert read(_run([0.4, 0.2], key)) == pytest.approx(0.3)


@pytest.mark.parametrize("metric,key", list(READERS.items()))
def test_reader_finds_nothing_to_read(metric, key):
    read = catalog.reader(metric)
    assert read({}) is None
    assert read(dict(calls=[])) is None
    run = _run([0.5, 0.1], key)
    del run["calls"][1]["cache"][key]          # a program without the counter
    assert read(run) is None


def test_each_reader_has_its_entry():
    bench = catalog.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READERS:
        m = entries[metric]
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "s", "lower")
        assert len(m["workloads"]) == 1
