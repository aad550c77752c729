"""The control of a cell's `correct`: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
the configuration states, at the cell's own size, against the float32
reference. Every number must come out over its limit.

    python portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--iterations N]

`--iterations` is the iterations a render cell's run accumulates (a run's
window at run_seconds); the train cell follows its three checked steps.
Prints one JSON line a seed. Not part of a run: the benchmark's runs never
call it."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]


def render_numbers(cell, seed: int, iterations: int, device) -> dict:
    import torch
    from harness import inputs
    from harness.checks import image_gap
    from reference import scene as RS
    from reference import tracer as R
    path = inputs.write_scene(cell.config, seed)
    with open(path) as f:
        sc = RS.parse(f.read(), os.path.dirname(path))
    nee = bool(cell.traffic["params"].get("nee", False))
    pix = torch.as_tensor(inputs.pixel_sample(
        seed, sc.width * sc.height, int(cell.settings["check_pixels"])),
        device=device)
    means = []
    for dt in (torch.float32, torch.bfloat16):
        tab = R.Tables(sc, device, dt)
        acc = torch.zeros((pix.numel(), 3), dtype=torch.float64,
                          device=device)
        lanes = pix.numel() * iterations
        for s in range(0, lanes, 1 << 20):
            idx = torch.arange(s, min(s + (1 << 20), lanes), device=device)
            slot, it = idx // iterations, idx % iterations
            rad = R.trace(tab, pix[slot], R.LatticeDraws(it, pix[slot]),
                          sc.depth, nee=nee)
            acc.index_add_(0, slot, rad.double())
        means.append((acc / iterations).cpu().numpy())
    return dict(image_gap=image_gap(means[1], means[0]))


def _fault_render(render, fault: str):
    """The reference's render with a fault planted: "half" leaves the
    bottom half of the image out and doubles the rest (the loss's mean
    then runs over the top half alone); "scaled" alters every pixel's
    radiance by 1% where it is produced."""
    import torch

    def faulty(tab, gen_seed):
        img = render(tab, gen_seed)
        if fault == "half":
            rows = torch.arange(img.shape[0], device=img.device)
            keep = (rows < img.shape[0] // 2).to(img.dtype)
            return img * (2.0 * keep)[:, None, None]
        return img * 1.01
    return faulty


def train_numbers(cell, seed: int, device, fault: str = "control") -> dict:
    """The control (fault "control": bfloat16) or a planted fault ("half",
    "scaled") against the float32 reference."""
    import torch
    from harness import checks, inputs
    from mixes.train_steps import CHECKED_CALLS, MAX_CALLS
    from reference import scene as RS
    from reference import train as RT
    path = inputs.write_scene(cell.config, seed)
    with open(path) as f:
        sc = RS.parse(f.read(), os.path.dirname(path))
    lr = float(cell.traffic["params"]["learning_rate"])
    hist = inputs.seed32(inputs.history_seed(seed), 0)
    steps = [inputs.seed32(s, 0) for s in
             inputs.call_seeds(seed, MAX_CALLS)[:CHECKED_CALLS]]
    sides = [RT.train(sc, device, hist, steps, lr=lr)]
    if fault == "control":
        sides.append(RT.train(sc, device, hist, steps, lr=lr,
                              dtype=torch.bfloat16))
    else:
        clean = RT.render
        RT.render = _fault_render(clean, fault)
        try:
            sides.append(RT.train(sc, device, hist, steps, lr=lr))
        finally:
            RT.render = clean

    def view(r):
        return dict(losses=r["losses"], grad=r["grads"][0],
                    start=r["start"], after=r["params"][CHECKED_CALLS - 1])
    return checks.train_numbers(view(sides[1]), view(sides[0]))


def main(argv) -> int:
    import argparse
    import json
    import torch
    from harness.spec import load_cell
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--iterations", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="control",
                   choices=("control", "half", "scaled"))
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    dev = torch.device(a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        if cell.mix == "train_steps":
            nums = train_numbers(cell, seed, dev, a.fault)
        else:
            if a.iterations <= 0:
                raise SystemExit("--iterations is needed for a render cell")
            nums = render_numbers(cell, seed, a.iterations, dev)
        limits = cell.settings["limits"]
        print(json.dumps(dict(workload=a.workload, seed=seed, fault=a.fault,
                              numbers=nums,
                              over_limit={k: v > limits[k] for k, v in
                                          nums.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
