"""scene_load_s: the host seconds of the program's `load_scene` (parse, the
mesh's BVH build and 8-wide packing), the benchmark's span around it."""


def read(rec):
    return rec["setup_spans"].get("scene_load")
