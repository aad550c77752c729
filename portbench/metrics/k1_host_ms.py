"""k1_host_ms: the mean host ms of the program's `render.k1` span in the
traced sub-window: `Renderer.step`'s checks and launch of one K1 iteration
on the megakernel route, against the kernel's ~0.23 ms on the card. None
where the program records no such span."""
from harness import program_spans


def read(rec):
    return program_spans.mean_ms(program_spans.spans(rec, "render.k1"))
