"""train_io_ms: host ms of the program's `train.load` (copy-in) and
`train.unload` (copy-out with the state's clones) spans per train call in
the traced sub-window."""
from harness import program_spans


def read(rec):
    load = program_spans.spans(rec, "train.load")
    out = program_spans.spans(rec, "train.unload")
    if not load:
        return None
    return 1e3 * sum(e - s for s, e in load + out) / len(load)
