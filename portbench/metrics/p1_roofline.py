"""p1_roofline: P1's share of its roofline, in percent, summed over an
iteration's launches: the least time of the bytes its fetches need at the
published bandwidth (harness/roofline_tex.py; the fetching lanes from the
reference's retrace) over P1's device time an iteration in the traced
sub-window. Returns (share, bound)."""
from harness import profiling, roofline


def read(rec):
    works, its = rec.get("p1_works"), rec.get("iterations")
    if not works or not its:
        return None
    t = profiling.device_seconds(
        rec, lambda n: profiling.hand_kernel(n) == "p1") / its
    return roofline.share(works, t) if t > 0 else None
