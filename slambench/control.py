"""The readings that the limits of ``limits/<cell>.json`` are set from, at
a cell's own size, on the card:

    python3 slambench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the run's worlds as ``run.py`` does, serves each of
the worlds the check would sample once through the cell's entry, and
prints, for each world, every number of ``reference/compare.py`` that the
check reads, for three answers:

* ``sound``: the program's (its readings over a dozen seeds or more are
  the lower readings; the benchmark's own runs print them too);
* ``control``: the reference computed in bfloat16, the precision below
  the configuration's float32, put in the program's place (the upper
  reading: it has to fail);
* ``no_refine``: the float32 reference with its refinement sweeps left
  out (a stage that returns its state unchanged), in the program's place.

The reference is the one the cell's configuration names, with the
parameters the entry took from it (``Entry.ref``, ``Entry.params``).
One JSON line a seed and world.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from slambench.harness.registry import Registry

    reg = Registry(ROOT)
    spec = reg.cell(args.workload)
    config = reg.config(spec["config"])
    limits = reg.limits(args.workload)

    def answer(r):
        return (r.x_init, r.x, r.map_pos, r.map_counts)

    for seed in args.seeds:
        gen = reg.generator(spec["traffic"], config, seed, args.device)
        params = gen.params
        worlds = gen.held(seed, range(len(gen.worlds)),
                          limits["check_worlds"])
        answers, i = {}, 0
        while not set(worlds) <= set(answers):
            r = gen.request(i)
            answers.update(zip(r.worlds, r.answers))
            i += 1
        del gen.datasets
        for k in worlds:
            t0 = time.perf_counter()
            f32 = gen.reference(k, params)
            bf16 = gen.reference(k, params, torch.bfloat16)
            skip = gen.reference(k, params.replace_n(0))
            print(json.dumps({
                "cell": args.workload, "seed": seed, "world": k,
                "sound": gen.numbers(k, answers[k], f32, params),
                "control": gen.numbers(k, answer(bf16), f32, params),
                "no_refine": gen.numbers(k, answer(skip), f32, params),
                "limits": limits["limits"],
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
