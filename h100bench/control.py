"""The readings a cell's correctness limit is set from, on the card:

    python3 -m h100bench.control --workload <cell> --seeds 11,12,... \\
        --control-seeds 3 --seconds 20 [--out FILE]

In one process (set-up is long), for each seed: one run of the cell as the
benchmark runs it (a short window at the cell's own load), the widest gap of
its served tokens (the lower reading), and for the first ``--control-seeds``
seeds the control's widest gap at the same rows (the reference computed in
float8, the architecture's ``reference(..., quant="fp8")``: the upper
reading). One JSON object a seed on standard output, and in ``--out``. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from h100bench import check, serve, spec

    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("h100bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = serve.run(cell, seed, args.seconds, False, "cuda")
        row = {"seed": seed, "max_logit_gap": out["max_logit_gap"],
               "tokens_compared": out["tokens_compared"],
               "failed": sum(1 for t in out["run"].sent() if not t.ok),
               "timeline": out["timeline"]}
        if i < args.control_seeds:
            sample = check.sample(serve.served_turns(out["run"]), seed)
            row["control_gap"] = check.control_gap(
                serve.reference(cell, seed, "cuda"),
                serve.reference(cell, seed, "cuda", quant="fp8"), sample)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
