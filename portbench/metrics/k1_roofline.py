"""k1_roofline: K1's share of its roofline, in percent: the least time of
an iteration's FP32 operations at the published peak (harness/
roofline_k1.py; the segments from the reference's retrace) over K1's device
time an iteration in the traced sub-window. Returns (share, bound)."""
from harness import profiling, roofline


def read(rec):
    works, its = rec.get("k1_works"), rec.get("iterations")
    if not works or not its:
        return None
    t = profiling.device_seconds(
        rec, lambda n: profiling.hand_kernel(n) == "k1") / its
    return roofline.share(works, t) if t > 0 else None
