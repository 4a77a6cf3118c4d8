"""Readings that the limits of a cell's ``correct`` are set from, at the
cell's own sizes, in one process (on the card unless ``--device cpu``):

* the program, through its checked steps, against the reference, on each
  of ``--seeds`` (the lower readings);
* on each of ``--control-seeds``, each against the reference: the control
  (the reference computed in fp8, the precision below the configuration's
  bf16) and faults planted in the reference put in the program's place:
  half of each batch left out (the mean taken over the rest), AdamW's
  weight decay left out, and its second moment's decay b2 set to 0.999 (the
  upper readings, and what each number does or does not see).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--device cpu] [--detail FILE]

One JSON line a seed, then the largest program reading and the smallest of
each fault's. A state returned unchanged reads 1 on ``change_gap`` and
``moment_gap`` by the measures' own definition and needs no run. The
benchmark's runs never run this.
"""
import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: planted in the reference, with the reference's keyword arguments
FAULTS = {"half_batch": lambda t: {"rows_kept": t["global_batch"] // 2},
          "no_weight_decay": lambda t: {"optimizer": {"weight_decay": 0.0}},
          "b2_0.999": lambda t: {"optimizer": {"b2": 0.999}}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--detail", default="",
                   help="a file for every reading, leaf by leaf (JSON lines)")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import check, harness
    from portbench.reference import train as plain

    cell = harness.find_cell(args.workload, ROOT)
    kind = cell.kind()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = {"program": [], "control": [], **{f: [] for f in FAULTS}}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt:
            program = kind.Program(cell, seed, args.device, ckpt)
            sides = {"program": program.checked_steps()}
            grads = {"program": program.first_grads}
            del program
        kind.free(args.device)
        if seed in controls:
            sides["control"] = kind.reference_readings(
                cell, seed, args.device, cast=plain.fp8, keep_grads=True)
            for name, kw in FAULTS.items():
                sides[name] = kind.reference_readings(
                    cell, seed, args.device, keep_grads=True,
                    **kw(cell.traffic))
            for name in sides:
                if name != "program":
                    grads[name] = sides[name].pop("first_grads")
        ref = kind.reference_readings(cell, seed, args.device, against=grads)
        del grads
        line = {"seed": seed, "losses": sides["program"]["losses"]}
        for name, side in sides.items():
            side["grad_diffs"] = ref["grad_diffs"][name]
            line[name] = check.numbers(side, ref)
            rows[name].append(line[name])
        del ref["grad_diffs"]
        if args.detail:
            with open(args.detail, "a") as f:
                f.write(json.dumps({"seed": seed, "reference": ref,
                                    **sides}) + "\n")
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(r[k] for r in rows["program"])
                               for k in rows["program"][0]}}
    for key, found in rows.items():
        if key != "program" and found:
            summary[key + "_min"] = {k: min(r[k] for r in found)
                                     for k in found[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
