"""readback_copy_ms: the mean host ms of the program's `readback.copy`
span in the traced sub-window (`Renderer.image()`'s device-to-host copy
of the accumulator)."""
from harness import program_spans


def read(rec):
    return program_spans.mean_ms(program_spans.spans(rec, "readback.copy"))
