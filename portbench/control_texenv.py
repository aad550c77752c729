"""The control of a textured cell's `correct` (texenv-render): the plain
reference of reference/texenv.py put in the program's place and computed
in bfloat16, the precision below the float32 the configuration states, at
the cell's own size, against the float32 reference. Every number must come
out over its limit. control.py's render half, for the scenes that
reference/tracer.py cannot trace (textures, the sky, glass).

    python portbench/control_texenv.py --workload texenv-render \
        --seeds 1,2,3 --iterations N

`--iterations` is the iterations a run's window accumulates at
run_seconds. Prints one JSON line a seed. Not part of a run: the
benchmark's runs never call it."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]


def render_numbers(cell, seed: int, iterations: int, device) -> dict:
    import torch
    from harness import inputs
    from harness.checks import image_gap
    from reference import texenv as TX
    ts = TX.load(inputs.write_scene(cell.config, seed))
    sc = ts.scene
    pix = torch.as_tensor(inputs.pixel_sample(
        seed, sc.width * sc.height, int(cell.settings["check_pixels"])),
        device=device)
    ref, low = (TX.retrace(TX.Tables(ts, device, dt), pix, iterations,
                           sc.depth)
                for dt in (torch.float32, torch.bfloat16))
    return dict(image_gap=image_gap(low, ref))


def main(argv) -> int:
    import argparse
    import json
    import torch
    from harness.spec import load_cell
    p = argparse.ArgumentParser(prog="portbench/control_texenv.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--iterations", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    dev = torch.device(a.device)
    limits = cell.settings["limits"]
    for seed in (int(s) for s in a.seeds.split(",")):
        nums = render_numbers(cell, seed, a.iterations, dev)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              fault="control", numbers=nums,
                              over_limit={k: v > limits[k] for k, v in
                                          nums.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
