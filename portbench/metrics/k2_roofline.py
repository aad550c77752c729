"""k2_roofline: K2's share of its roofline, in percent, summed over an
iteration's launches: the least time of their bytes at the published
bandwidth (harness/roofline.py; the live rays from the reference's retrace)
over K2's device time an iteration in the traced sub-window. Returns
(share, bound)."""
from harness import profiling, roofline


def read(rec):
    works, its = rec.get("k2_works"), rec.get("iterations")
    if not works or not its:
        return None
    t = profiling.device_seconds(
        rec, lambda n: profiling.hand_kernel(n) == "k2") / its
    return roofline.share(works, t) if t > 0 else None
