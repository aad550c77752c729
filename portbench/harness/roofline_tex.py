"""P1's least time at the published peak, from the fetches the inputs need
(not from how P1 is launched), beside roofline.k2_work.

P1 fetches one 32-bit texel a lane from the fused atlas+env table
(ops/texfetch.fuse). What a bounce's inputs need of it: for each lane that
reads a texel, a textured hit or a miss into the sky, an int32 index in
and a 32-bit texel out, and the table read once. Lanes that read none (a
dead path, an untextured hit) are not counted, so a launch over every lane
pays for them in its time and not in its work. Its operations are index
arithmetic and are not counted: bytes bound it."""
from __future__ import annotations

from typing import Dict

P1_FETCH_BYTES = 4 + 4      # the index in, the texel out
P1_TEXEL_BYTES = 4          # a texel of the table


def p1_work(fetches: int, table_texels: int) -> Dict[str, float]:
    """One P1 launch's bytes (its operations are not counted: 0)."""
    return dict(flops=0.0, bytes=float(fetches * P1_FETCH_BYTES
                                       + table_texels * P1_TEXEL_BYTES))
