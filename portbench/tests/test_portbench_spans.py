"""The readers of the program's own spans and counters
(harness/program_spans.py, metrics/graph_nodes.*, replay_host_ms.*,
replay_idle_ms.*, readback_copy_ms, train_io_ms) on synthetic records:
spans outside the sub-window are left out, idle is clipped to the window
and to the spans, and a program with no such span or no recorder reads
None."""
import os

import pytest

import pb_small
from harness import program_spans as PS
from harness import spec


class _Recorder:
    def __init__(self, spans=(), counters=None):
        self._spans, self._counters = list(spans), dict(counters or {})

    def spans(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


def _use(monkeypatch, rec):
    monkeypatch.setattr(PS, "_recorder", lambda: rec)


def _reader(name):
    return spec.load_module(os.path.join(pb_small.BENCH, "metrics",
                                         name + ".py"),
                            "pb_test_" + name.replace(".", "_")).read


# the window [10, 20]; the device busy on [10, 12], [13, 15], [19, 21]
RECORDS = dict(window=(10.0, 20.0), kernels=[("k", 10.0, 12.0),
                                             ("k", 13.0, 15.0)],
               copies=[("Memcpy DtoH", 19.0, 21.0)], iterations=2,
               steps=None)


def test_idle_inside_spans_is_clipped_to_the_window():
    # idle in the window: [12, 13] and [15, 19]
    assert PS.idle_inside(RECORDS, [(11.0, 16.0)]) == pytest.approx(2.0)
    assert PS.idle_inside(RECORDS, [(14.0, 25.0)]) == pytest.approx(4.0)
    assert PS.idle_inside(RECORDS, [(0.0, 10.0)]) == 0.0
    assert PS.idle_inside(dict(RECORDS, kernels=[], copies=[]),
                          [(5.0, 30.0)]) == pytest.approx(10.0)


def test_replay_readers_keep_the_sub_windows_spans(monkeypatch):
    _use(monkeypatch, _Recorder([
        ("render.replay", 8.0, 9.0),        # an earlier attempt: left out
        ("render.replay", 11.5, 13.5),      # 1 s idle inside
        ("render.prepare", 15.0, 19.0),     # another span
        ("render.replay", 17.0, 18.0),      # 1 s idle inside
        ("render.replay", 19.5, 20.5)]))    # ends past the window
    assert _reader("replay_host_ms.render")(RECORDS) == pytest.approx(
        1.5e3)
    assert _reader("replay_idle_ms.render")(RECORDS) == pytest.approx(
        1e3 * 2.0 / 2)
    # the train readers find no train spans, nor steps
    assert _reader("replay_host_ms.train")(RECORDS) is None
    assert _reader("replay_idle_ms.train")(RECORDS) is None


def test_readback_and_train_io(monkeypatch):
    _use(monkeypatch, _Recorder([
        ("readback.copy", 12.0, 12.5), ("readback.copy", 15.0, 15.25),
        ("train.load", 10.5, 10.75), ("train.unload", 11.0, 11.25),
        ("train.load", 16.0, 16.5), ("train.unload", 17.0, 17.5)]))
    assert _reader("readback_copy_ms")(RECORDS) == pytest.approx(375.0)
    assert _reader("train_io_ms")(RECORDS) == pytest.approx(
        1e3 * 1.5 / 2)


def test_graph_nodes_read_the_programs_counters(monkeypatch):
    _use(monkeypatch, _Recorder(counters={"render.graph_nodes": 32771,
                                          "render.kernel_nodes": 32700}))
    assert _reader("graph_nodes.render")(RECORDS) == 32771.0
    assert _reader("graph_nodes.train")(RECORDS) is None


@pytest.mark.parametrize("name", [
    "graph_nodes.render", "graph_nodes.train", "replay_host_ms.render",
    "replay_host_ms.train", "replay_idle_ms.render", "replay_idle_ms.train",
    "readback_copy_ms", "train_io_ms"])
def test_readers_return_none_without_a_recorder(monkeypatch, name):
    """A program without the recorder (an older checkout), or one that
    recorded nothing: every reader returns None and raises nothing."""
    _use(monkeypatch, None)
    assert _reader(name)(RECORDS) is None
    _use(monkeypatch, _Recorder())
    assert _reader(name)(RECORDS) is None


def test_the_programs_recorder_is_found():
    from project3_cuda_path_tracer_tpu_torch.utils import profiling
    assert PS._recorder() is profiling
