"""replay_host_ms.render: the mean host ms of the program's
`render.replay` span in the traced sub-window (`graph.replay()`: torch's
generator prologue and `cudaGraphLaunch`)."""
from harness import program_spans


def read(rec):
    return program_spans.mean_ms(program_spans.spans(rec, "render.replay"))
