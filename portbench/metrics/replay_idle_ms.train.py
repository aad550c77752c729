"""replay_idle_ms.train: device-idle ms inside the program's
`train.replay` spans, per step of the traced sub-window."""
from harness import program_spans


def read(rec):
    return program_spans.idle_ms_per(rec, "train.replay", "steps")
