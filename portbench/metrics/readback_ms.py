"""readback_ms: the mean host milliseconds of `Renderer.image()` a frame
over the window (the benchmark's span around each call)."""


def read(rec):
    xs = rec["unit_spans"].get("image")
    return 1e3 * sum(xs) / len(xs) if xs else None
