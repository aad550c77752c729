"""texture_load_s: the host seconds of the program's `scene.textures`
(decoding the TEXTURE and ENVMAP images in `load_scene`) and
`render.textures` (their upload and `texfetch.fuse` in the Renderer)
spans, summed over set-up. None where the program records neither."""
from harness import program_spans


def read(rec):
    p = program_spans._recorder()
    totals = {} if p is None else p.span_totals()
    parts = [totals[n][1] for n in ("scene.textures", "render.textures")
             if n in totals]
    return sum(parts) if parts else None
