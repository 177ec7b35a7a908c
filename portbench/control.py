"""Readings for the limits of ``correct``, at a cell's own size, several
seeds in one process (not part of a benchmark run):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --mode sound|control|half_batch|unchanged [--out file.jsonl]

- ``sound``: the program's first steps against the reference (the lower
  readings);
- ``control``: the reference computed in fp8 (``reference.common``) in the
  program's place, against the float32 reference;
- ``half_batch``, ``unchanged``: the program with that fault planted
  under the timed path (``harness.FAULTS``), against the reference.

Each seed prints one JSON line: the numbers compared, where each was
largest, and whether the cell's limits call it correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import correctness, harness  # noqa: E402


def readings(spec: dict, seed: int, mode: str, device="cuda") -> dict:
    """One seed's numbers in ``mode``."""
    cfg = spec["config"]
    steps = cfg["train"]["check_steps"]
    fam = harness.family(cfg)
    t0 = time.perf_counter()
    tensors = harness.wants_tensors(spec)
    pool = harness.make_pool(cfg, spec["mix"], seed)
    if mode == "control":
        prog = harness.reference_steps(cfg, pool, seed, steps, "fp8", device,
                                       tensors)
    else:
        weights = fam.make_weights(cfg, seed, device)
        with tempfile.TemporaryDirectory() as tmp:
            learner = harness.build_learner(cfg, weights, pool, seed, device,
                                            tmp)
            del weights
            if mode != "sound":
                harness.FAULTS[mode](learner)
            prog = harness.program_steps(cfg, learner,
                                         harness.feed(learner), steps,
                                         tensors)
            del learner
        harness.release()
    ref = harness.reference_steps(cfg, pool, seed, steps, "float32", device,
                                  tensors)
    harness.release()
    values, where = harness.compare(cfg, pool, prog, ref)
    return {"workload": spec["cell"]["name"], "mode": mode, "seed": seed,
            "values": values, "where": where,
            "correct": correctness.judge(values, spec["limits"]),
            "losses": prog["losses"], "ref_losses": ref["losses"],
            "seconds": time.perf_counter() - t0}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", *harness.FAULTS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = harness.resolve(args.workload, harness.manifest())
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(spec, seed, args.mode))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
