"""replay_idle_ms.render: device-idle ms inside the program's
`render.replay` spans, per iteration of the traced sub-window."""
from harness import program_spans


def read(rec):
    return program_spans.idle_ms_per(rec, "render.replay", "iterations")
