"""Tracing and profiling in the torch port (utils/profiling.py): the
counterpart of the JAX tests/test_profiling.py contract (a timed call is
waited for, `sync` takes nests and non-tensors, `ab_compare` times every
variant) and the trace: a Chrome trace file with the program's spans."""
import json
import time

import pytest
import torch

from project3_cuda_path_tracer_tpu_torch.utils import profiling


def test_time_fn_waits_for_the_call():
    sleep_s = 0.05

    def slow(x):
        time.sleep(sleep_s)
        return x * 2.0

    dt = profiling.time_fn(slow, torch.ones(4), iters=2, warmup=1)
    assert dt >= sleep_s * 0.8


def test_sync_handles_nests_and_non_tensors():
    profiling.sync({"a": torch.ones(2, 2), "b": 3})
    profiling.sync(("no", "tensors", 1))
    profiling.sync([torch.zeros(()), (torch.ones(1), {"c": None})])
    assert list(profiling._tensors({"a": (torch.ones(1), [torch.ones(2)]),
                                    "b": "x"}))[1].shape == (2,)


def test_ab_compare_returns_all_variants():
    x = torch.ones(8)
    out = profiling.ab_compare({"mul": lambda: x * 2.0,
                                "add": lambda: x + 1.0}, iters=2)
    assert set(out) == {"mul", "add"}
    assert all(v >= 0 for v in out.values())


@pytest.mark.parametrize("span", ["shade", "intersect"])
def test_trace_writes_chrome_trace_with_named_spans(tmp_path, span):
    """A program span inside trace() lands in its Chrome trace, on the
    program span track; it is no profiler range, so the profiler's own
    records (and its sums by op) do not hold it."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span(span):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {ev.key for ev in prof.key_averages()}
    assert span not in names and "aten::mm" in names
    assert [n for n, _, _ in profiling.spans()][-1] == span
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name") == span and ev.get("cat") == "program_span"
               and ev.get("tid") == profiling.SPAN_TRACK for ev in events)
