"""The check's control, on the card: for each seed, one window of the cell
at its own load, then the check's numbers twice over the same served
requests: the program's, and the control's (the plain reference put
in the program's place at the precision below the configuration's: int8
weights and KV cache at int4 and bf16 weights at fp8 for the serving mode,
fp8 weights and activations for a bf16 model, a bf16 codec for an f32 one,
an fp8 codec for a bf16 one).

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One JSON line a seed on standard output. The limits in the cell's file are
set between the program's largest reading and the control's smallest (see
PERF.md). The benchmark's own runs do not run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402
import registry  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device, root: str = registry.HERE):
    """(the program's numbers, the control's numbers, served codes checked)."""
    import reference.check as check
    import sut

    ctx = harness.context(workload, seed, device, root)
    driver = registry.driver(ctx.mix["driver"], root).Driver(ctx)
    driver.setup()
    rec = driver.run(seconds, False)
    sample = driver.served_sample(rec)
    driver.release()
    del driver, rec
    weights = sut.cell_weights(ctx)
    mode = {"int8": ctx.mix["int8"], "codec_dtype": ctx.mix["codec_dtype"]}
    own = check.readings(weights, ctx.cfg, sample, mode)
    control = check.readings(weights, ctx.cfg, sample, mode, control=True)
    return own, control, sum(int(r["codes"].size) for r in sample)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        own, control, codes = readings(args.workload, seed, args.seconds, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, "codes": codes,
                          "program": own, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
