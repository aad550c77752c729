"""graph_capture_s: the seconds the program's captured CUDA graph took to
capture and instantiate (its own `CapturedGraph.capture_s` and
`instantiate_s`)."""


def read(rec):
    cap = rec.get("capture")
    return None if cap is None else float(cap[0] + cap[1])
